"""Data-parallel attention ranks stepping in lockstep (copied from
ray_tpu/serve/dp_attention.py).

For MoE models, N attention-DP ranks each own their KV cache and request
stream but must step in lockstep: expert layers all-to-all across ranks
every decode round, so an idle rank still runs a dummy batch rather than
stalling the collective.

Each rank is a PagedLLMEngine in external-step mode hosted by a thread
actor (``_DPRank``), and a coordinator thread drives one synchronized
``step_once`` round at a time: ``ray_tpu_torch.get([rank.step.remote()
...])`` is the lockstep. An idle rank runs a dummy decode (the same
forward over zeroed rows; on a CUDA device through the paged kernel), and a
fully idle group only probes its ranks' loads instead of stepping.

Where the port differs from the reference: the in-process runtime has no
placement groups, so ``use_placement_group=True`` (the reference's gang
reservation) raises ``NotImplementedError`` naming ROADMAP queue 1 item 4;
pass ``False``. ``params`` and ``device`` go to every rank's engine
(``params=None``: rank i draws its weights from a ``torch.Generator``
seeded i, as the reference seeds rank i's engine with i). The coordinator
counts its idle probes (``probes``) and notifies ``wait_for`` callers after
every round and probe, so a caller can wait for a state with a deadline
instead of sleeping.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from concurrent.futures import Future
from typing import Optional

import ray_tpu_torch
from ray_tpu_torch.serve.llm_paged import PagedLLMEngine

_PLACEMENT_ITEM = "ROADMAP queue 1 item 4"
_IDLE_PROBE_S = 0.02  # between probes of a fully idle group
_FAILED_ROUND_S = 0.5  # after a failed round

log = logging.getLogger("ray_tpu_torch.serve.dp_attention")


class _DPRank:
    """One attention-DP rank: engine + request registry (actor body)."""

    def __init__(self, llm_config, seed: int = 0, params=None, device=None):
        self.engine = PagedLLMEngine(llm_config, params=params, seed=seed, external_step=True,
                                     device=device)
        self._futs: dict[str, Future] = {}
        self.dummy_decodes = 0

    def submit(self, prompt_ids: list[int], max_new_tokens: int) -> str:
        rid = uuid.uuid4().hex[:12]
        self._futs[rid] = self.engine.generate(prompt_ids, max_new_tokens)
        return rid

    def step(self) -> int:
        """One lockstep round: real work if any, else a dummy decode (idle
        ranks keep the collective's cadence). A dummy-decode failure
        propagates. Returns active + queued sequences after the round."""
        did = self.engine.step_once()
        if not did:
            self.engine.dummy_decode()
            self.dummy_decodes += 1
        return self.active_count()

    def poll(self, rid: str):
        fut = self._futs.get(rid)
        if fut is None:
            raise KeyError(f"unknown request {rid}")
        if not fut.done():
            return None
        self._futs.pop(rid, None)
        exc = fut.exception()
        if exc is not None:
            raise exc
        r = fut.result()
        return {"token_ids": r.token_ids, "prompt_len": r.num_prompt_tokens}

    def cancel(self, rid: str) -> bool:
        """Reap an abandoned request (client timed out): free its decode slot
        so it stops consuming lockstep rounds, and drop the future."""
        fut = self._futs.pop(rid, None)
        if fut is None:
            return False
        self.engine.cancel_future(fut)
        if not fut.done():
            fut.set_exception(TimeoutError("request cancelled by client timeout"))
        return True

    def active_count(self) -> int:
        return int(self.engine.active.sum()) + self.engine._pending.qsize()

    def stats(self) -> dict:
        """The engine's stats (``decode_steps`` counts its real decode
        steps) and the dummy decodes this rank ran."""
        return {**self.engine.stats(), "dummy_decodes": self.dummy_decodes}

    def shutdown(self) -> None:
        self.engine.shutdown()


class DPAttentionGroup:
    """N DP ranks stepping in lockstep (reference: DPServer)."""

    def __init__(self, llm_config, dp_size: int = 2, use_placement_group: bool = True,
                 round_interval_s: float = 0.0, params=None, device=None):
        if use_placement_group:
            raise NotImplementedError(
                "DPAttentionGroup(use_placement_group=True): the port's runtime has no "
                f"placement groups yet ({_PLACEMENT_ITEM}); pass use_placement_group=False")
        self.ranks = [ray_tpu_torch.remote(num_cpus=1)(_DPRank).remote(
            llm_config, seed=i, params=params, device=device) for i in range(dp_size)]
        self._interval = round_interval_s
        self._stop = threading.Event()
        self._cv = threading.Condition()
        self.rounds = 0
        self.probes = 0  # idle probes of a fully idle group
        self.idle = False
        self.healthy = True
        self.last_error: Optional[str] = None
        self._thread = threading.Thread(target=self._drive, daemon=True,
                                        name="dp-attention-coordinator")
        self._thread.start()

    # ---- routing (least-loaded rank takes the new request) ----
    def generate(self, prompt_ids: list[int], max_new_tokens: int = 16,
                 timeout: float = 120.0) -> dict:
        if not self.healthy:
            raise RuntimeError(f"DP group unhealthy: {self.last_error}")
        loads = ray_tpu_torch.get([r.active_count.remote() for r in self.ranks], timeout=60)
        rank = self.ranks[loads.index(min(loads))]
        rid = ray_tpu_torch.get(rank.submit.remote(list(prompt_ids), max_new_tokens),
                                timeout=60)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not self._stop.is_set():
            out = ray_tpu_torch.get(rank.poll.remote(rid), timeout=60)
            if out is not None:
                return out
            self._stop.wait(0.01)
        # reap: an abandoned sequence would hold its slot to max_new_tokens,
        # burning lockstep rounds for every rank, and leak its future
        try:
            ray_tpu_torch.get(rank.cancel.remote(rid), timeout=10)
        except Exception:  # noqa: BLE001 - the rank may be gone with the group
            pass
        raise TimeoutError("DP generate timed out")

    def wait_for(self, predicate, timeout: float) -> bool:
        """Wait until ``predicate(self)`` holds, re-checked after every round
        and probe; False at the deadline."""
        with self._cv:
            return self._cv.wait_for(lambda: predicate(self), timeout=timeout)

    def _notify(self, **changes) -> None:
        with self._cv:
            for k, v in changes.items():
                setattr(self, k, v)
            self._cv.notify_all()

    def _drive(self) -> None:
        idle = False
        while not self._stop.is_set():
            try:
                if idle:
                    # a fully idle group has no collective to keep in step:
                    # a cheap probe instead of a dummy round on every rank
                    counts = ray_tpu_torch.get([r.active_count.remote() for r in self.ranks],
                                               timeout=60)
                    if sum(counts) == 0:
                        self._notify(probes=self.probes + 1)
                        self._stop.wait(_IDLE_PROBE_S)
                        continue
                # the barrier: every rank steps exactly once per round
                counts = ray_tpu_torch.get([r.step.remote() for r in self.ranks], timeout=120)
                idle = sum(counts) == 0
                self._notify(rounds=self.rounds + 1, healthy=True, idle=idle)
            except Exception as e:  # noqa: BLE001
                if self._stop.is_set():
                    return
                # a dead rank stalls the whole group (the collective needs
                # every rank): flag it and log it
                self._notify(healthy=False, last_error=repr(e))
                log.warning("DP lockstep round failed: %r", e)
                self._stop.wait(_FAILED_ROUND_S)
            if self._interval:
                self._stop.wait(self._interval)

    def stats(self) -> list[dict]:
        """Each rank's ``_DPRank.stats``."""
        return ray_tpu_torch.get([r.stats.remote() for r in self.ranks], timeout=60)

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=130)
        for r in self.ranks:
            try:
                ray_tpu_torch.get(r.shutdown.remote(), timeout=10)
            except Exception:  # noqa: BLE001 - a rank already gone
                pass
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001
                pass
