"""Disaggregated prefill/decode serving (copied from ray_tpu/serve/pd.py).

Prefill is burst-compute-bound and decode memory-bandwidth-bound, so they
run as separate deployments that scale independently:

- ``PDPrefill`` replicas own a PagedLLMEngine: ``prefill(body)`` computes
  the prompt's KV pages and first token (``prefill_extract``) and returns a
  handoff (the pages, first token, block table, sampling state). Routed
  with ``kv_aware`` prompt-prefix affinity so shared prefixes prefill once.
- ``PDDecode`` replicas own their own engine: ``decode(body)`` adopts the
  handoff's pages into its pool (``attach_sequence``) and decodes.
- ``PDController`` is the ingress deployment joining the two: one POST
  body in, prefill -> handoff -> decode, tokens out.

``build_pd_deployment`` is the co-located shape (one replica owning both
engines, the handoff in-process) the disaggregated app is held against.

Where the port differs from the reference:

- ``kv_transfer="host"`` replaces ``"plane"``: the handoff dict carries the
  pages as CPU tensors (``[L, Hkv, n_blocks, block_size, D]``, the model's
  own head dim) and goes from the prefill replica through the controller's
  handle to the decode replica, by reference, in one process.
- No ``KVTransport``: the object-plane transport, and with it the
  reference's re-prefill of a handoff lost between the phases
  (``kv_handoff_lost``), waits for ROADMAP queue 1 item 8. A handoff that
  carries a plane reference (``kv_ref``) and no pages raises
  ``NotImplementedError`` naming that item; a host handoff cannot be lost.
- ``compiled_dispatch`` stays off: serve's compiled dispatch is built on
  compiled graphs, ROADMAP queue 1 item 8.
- ``ray_actor_options={"num_gpus": 0.0}`` replaces ``{"num_tpus": 0.0}``.
- Weights come from a ``params=`` argument (shared by reference by every
  engine of the app) where the reference seeds a JAX init with
  ``PRNGKey(0)``, which the port cannot reproduce: its tests pass the JAX
  init's weights through ``models.llama.from_jax``. With ``params=None``
  each engine draws ``llama.init`` from a ``torch.Generator`` seeded 0.
- ``stats()`` reports, for each side, ``kv.live_handoffs``: handoffs
  extracted (prefill side) or received (decode side) by that replica and
  neither attached nor dropped yet (``_Handoffs``). A handoff carries its
  prefill replica's close (``"_close"``), which the decode side calls once
  the pages land in its pool. It stands in for the transport's count of
  published and unacknowledged entries; after a request completes it is 0
  on both sides.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time

import ray_tpu_torch
from ray_tpu_torch.serve import anatomy
from ray_tpu_torch.serve.deployment import deployment
from ray_tpu_torch.serve.llm_paged import PagedLLMConfig, PagedLLMEngine

_PLANE_ITEM = "ROADMAP queue 1 item 8"


class _Handoffs:
    """One replica's live handoffs: opened when the prefill side extracts
    one (or the decode side receives one), closed when its pages are
    attached to a decode pool or it is dropped; closing twice is a no-op."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._open: set[int] = set()

    def open(self) -> int:
        with self._lock:
            hid = next(self._ids)
            self._open.add(hid)
        return hid

    def close(self, hid: int) -> None:
        with self._lock:
            self._open.discard(hid)

    def __len__(self) -> int:
        with self._lock:
            return len(self._open)


class _ReplicaLifecycle:
    """Shared PD replica teardown: stop every engine loop. Runs via the
    explicit ``shutdown`` method or ``__del__`` once a killed replica's
    instance is dropped, so replica churn (redeploy, scale-down, kill)
    cannot accrete engine threads."""

    def _engines(self):
        return [self.engine]

    def _init_tag(self) -> None:
        self.tag = f"{type(self).__name__}-{id(self):x}"

    def shutdown(self) -> None:
        for e in self._engines():
            e.shutdown()

    def __del__(self):
        try:
            self.shutdown()
        except Exception:  # noqa: BLE001 - a half-built replica has no engine
            pass


def _init_engine(decode_cfg, prefill_cfg=None, *, params=None, device=None):
    """One parameter set shared by every PD engine (same model both sides):
    ``params`` by reference, or a ``torch.Generator`` seeded 0 when None."""
    cfg = prefill_cfg or decode_cfg
    engine = PagedLLMEngine(cfg, params=params, device=device)
    return engine, engine.params


def build_prefill_deployment(config=None, *, prefill_config=None, num_replicas: int = 1,
                             name: str = "PDPrefill", slo_ttft_ms: float | None = None,
                             autoscaling_config=None, params=None, device=None):
    """The prefill fleet: KV pages out, handoffs back."""
    cfg = config or PagedLLMConfig()

    @deployment(name=name, num_replicas=num_replicas,
                ray_actor_options={"num_gpus": 0.0}, max_ongoing_requests=32,
                request_router="kv_aware", slo_ttft_ms=slo_ttft_ms,
                autoscaling_config=autoscaling_config)
    class PrefillServer(_ReplicaLifecycle):
        def __init__(self, decode_cfg, prefill_cfg, params, device):
            self.engine, _ = _init_engine(decode_cfg, prefill_cfg, params=params,
                                          device=device)
            self.handoffs = _Handoffs()
            self._init_tag()

        def prefill(self, body: dict) -> dict:
            t0 = time.monotonic()
            t0_w = anatomy.now_wall()
            h = self.engine.prefill_extract(body.get("prompt_ids", []))
            hid = self.handoffs.open()
            rid = anatomy.rid_of(body)
            if rid is not None:
                # the prefill_exec window brackets the engine call
                anatomy.stamp(rid, "prefill_exec", t0_w, anatomy.now_wall())
            return {
                "handoff": {
                    "kv": h["kv"],
                    # the decode side closes this replica's entry once the
                    # pages land (in one process the handle passes it as is)
                    "_close": functools.partial(self.handoffs.close, hid),
                    "first_token": h["first_token"],
                    "prompt_len": h["prompt_len"],
                    "n_prefill_blocks": h["n_prefill_blocks"],
                    # page order within the handoff that attach scatters in
                    # (identity); the engine checks its length against the
                    # pages that arrived
                    "block_table": list(range(h["n_prefill_blocks"])),
                    # the sampling state the decode fleet checks against its
                    # own config
                    "sampling": {"temperature": self.engine.config.temperature},
                    "prompt_ids": h["prompt_ids"],
                },
                "prefill_s": time.monotonic() - t0,
                "replica": self.tag,
            }

        def stats(self) -> dict:
            return {**self.engine.stats(), "kv": {"live_handoffs": len(self.handoffs)}}

        def check_health(self) -> None:
            pass

    return PrefillServer.bind(cfg, prefill_config, params, device)


def build_decode_deployment(config=None, *, num_replicas: int = 1, name: str = "PDDecode",
                            slo_ttft_ms: float | None = None, autoscaling_config=None,
                            params=None, device=None):
    """The decode fleet: handoffs in, tokens out."""
    cfg = config or PagedLLMConfig()

    @deployment(name=name, num_replicas=num_replicas,
                ray_actor_options={"num_gpus": 0.0}, max_ongoing_requests=32,
                request_router="kv_aware", slo_ttft_ms=slo_ttft_ms,
                autoscaling_config=autoscaling_config)
    class DecodeServer(_ReplicaLifecycle):
        def __init__(self, decode_cfg, params, device):
            self.engine, _ = _init_engine(decode_cfg, params=params, device=device)
            self.handoffs = _Handoffs()
            self._init_tag()

        def decode(self, body: dict) -> dict:
            handoff = dict(body["handoff"])
            hid = self.handoffs.open()
            close_prefill = handoff.pop("_close", None) or (lambda: None)

            def close() -> None:  # attached or dropped: closed on both sides
                close_prefill()
                self.handoffs.close(hid)

            if handoff.get("kv") is None:
                close()
                raise NotImplementedError(
                    "the handoff carries no host KV pages: the object-plane transport "
                    f"(kv_ref) and its lost-handoff re-prefill wait for {_PLANE_ITEM}")
            rid = anatomy.rid_of(body)
            if rid is not None:
                # the engine stamps decode_first_token for this rid
                handoff["_rid"] = rid
            max_tokens = body.get("max_tokens")
            if max_tokens is None:
                max_tokens = 32
            # a sampling-state mismatch across the fleets must fail loudly,
            # not decode other tokens than the prefill side sampled
            temp = (handoff.get("sampling") or {}).get("temperature")
            if temp is not None and temp != self.engine.config.temperature:
                close()  # dropped
                return {"error": "sampling_mismatch",
                        "detail": f"prefill temperature {temp} != decode "
                                  f"{self.engine.config.temperature}",
                        "replica": self.tag}
            handoff["_pulled"] = (handoff.pop("kv"), close)
            try:
                res = self.engine.attach_sequence(handoff, max_tokens).result(timeout=120)
            finally:
                close()  # dropped, if attach failed before the pages landed
            return {
                "token_ids": res.token_ids,
                "usage": {"prompt_tokens": res.num_prompt_tokens,
                          "completion_tokens": res.num_generated},
                "finish_reason": res.finish_reason,
                "replica": self.tag,
            }

        def stats(self) -> dict:
            return {**self.engine.stats(), "kv": {"live_handoffs": len(self.handoffs)}}

        def check_health(self) -> None:
            pass

    return DecodeServer.bind(cfg, params, device)


def build_pd_controller(prefill_name: str = "PDPrefill", decode_name: str = "PDDecode",
                        name: str = "PDIngress", num_replicas: int = 1,
                        slo_ttft_ms: float | None = None, autoscaling_config=None):
    """The ingress joining the fleets."""

    @deployment(name=name, num_replicas=num_replicas,
                ray_actor_options={"num_gpus": 0.0}, max_ongoing_requests=64,
                slo_ttft_ms=slo_ttft_ms, autoscaling_config=autoscaling_config)
    class PDController:
        def __init__(self, prefill_name: str, decode_name: str, name: str = "PDIngress"):
            self._prefill_name = prefill_name
            self._decode_name = decode_name
            self._name = name  # ledger deployment tag (anatomy)
            self._handles_lock = threading.Lock()
            self._pair = None

        def _handles(self):
            # calls run concurrently: the pair is made once, under a lock
            with self._handles_lock:
                if self._pair is None:
                    from ray_tpu_torch.serve.api import get_deployment_handle

                    self._pair = (get_deployment_handle(self._prefill_name),
                                  get_deployment_handle(self._decode_name))
                return self._pair

        def __call__(self, body: dict) -> dict:
            ph, dh = self._handles()
            # returns a rid only when this call newly admitted (a direct
            # handle call); an HTTP-proxied body arrives admitted and the
            # proxy owns its completion record
            self_rid = anatomy.admit(body, self._name)
            a = body.get("_anatomy")
            max_tokens = body.get("max_tokens")
            if max_tokens is None:
                max_tokens = 32  # explicit 0 honored (prefill-only probe)
            t0 = time.monotonic()
            try:
                sub = {"prompt_ids": body.get("prompt_ids", [])}
                if isinstance(a, dict):
                    # per-leg copy: the router writes its marks into it
                    sub["_anatomy"] = dict(a)
                pre = ray_tpu_torch.get(ph.prefill.remote(sub), timeout=120)
                dsub = {"handoff": pre["handoff"], "max_tokens": max_tokens}
                if isinstance(a, dict):
                    dsub["_anatomy"] = dict(a)
                out = ray_tpu_torch.get(dh.decode.remote(dsub), timeout=120)
                if isinstance(out, dict) and out.get("error"):
                    raise RuntimeError(f"PD decode failed: {out['error']}")
            except BaseException as e:
                if self_rid is not None:
                    anatomy.complete(self_rid, self._name, ok=False, err=str(e)[:200])
                raise
            result = {
                "token_ids": out["token_ids"],
                "usage": out["usage"],
                "timings": {"ttft_s": pre["prefill_s"], "total_s": time.monotonic() - t0},
                "finish_reason": out["finish_reason"],
                "disaggregated": True,
                "pd": {"prefill_replica": pre.get("replica"),
                       "decode_replica": out.get("replica")},
            }
            if self_rid is not None:
                anatomy.complete(self_rid, self._name, replica=out.get("replica"),
                                 ntokens=out["usage"].get("completion_tokens", 0))
            return result

        def stats(self) -> dict:
            ph, dh = self._handles()
            return {"prefill": ray_tpu_torch.get(ph.stats.remote(), timeout=30),
                    "decode": ray_tpu_torch.get(dh.stats.remote(), timeout=30)}

    return PDController.bind(prefill_name, decode_name, name)


def deploy_pd_app(config=None, *, prefill_config=None, num_prefill_replicas: int = 1,
                  num_decode_replicas: int = 1, route_prefix: str | None = "/pd",
                  name_prefix: str = "PD", slo_ttft_ms: float | None = None,
                  autoscaling_config=None, params=None, device=None):
    """Deploy the disaggregated app (prefill fleet, decode fleet and the
    controller ingress) and return the controller's handle.
    ``slo_ttft_ms`` and ``autoscaling_config`` go to both engine fleets; the
    ingress carries only the SLO tag. ``params`` and ``device`` go to every
    engine."""
    from ray_tpu_torch import serve

    prefill_name = f"{name_prefix}Prefill"
    decode_name = f"{name_prefix}Decode"
    serve.run(build_prefill_deployment(
        config, prefill_config=prefill_config, num_replicas=num_prefill_replicas,
        name=prefill_name, slo_ttft_ms=slo_ttft_ms, autoscaling_config=autoscaling_config,
        params=params, device=device), route_prefix=None)
    serve.run(build_decode_deployment(
        config, num_replicas=num_decode_replicas, name=decode_name, slo_ttft_ms=slo_ttft_ms,
        autoscaling_config=autoscaling_config, params=params, device=device),
        route_prefix=None)
    # named apart from build_pd_deployment's "PDServer", so both shapes can
    # be deployed side by side
    return serve.run(build_pd_controller(prefill_name, decode_name,
                                         name=f"{name_prefix}Ingress",
                                         slo_ttft_ms=slo_ttft_ms),
                     route_prefix=route_prefix)


def build_pd_deployment(config=None, *, num_replicas: int = 1, prefill_config=None,
                        slo_ttft_ms: float | None = None, autoscaling_config=None,
                        params=None, device=None):
    """The co-located shape: one replica owns both engines and hands the KV
    over in-process.

    POST body: {"prompt_ids": [...], "max_tokens": N} -> token ids + timings."""
    cfg = config or PagedLLMConfig()

    @deployment(name="PDServer", num_replicas=num_replicas,
                ray_actor_options={"num_gpus": 0.0}, max_ongoing_requests=32,
                slo_ttft_ms=slo_ttft_ms, autoscaling_config=autoscaling_config)
    class PDServer(_ReplicaLifecycle):
        def __init__(self, decode_cfg, prefill_cfg, params, device):
            self.prefill_engine, params = _init_engine(decode_cfg, prefill_cfg, params=params,
                                                       device=device)
            self.decode_engine = PagedLLMEngine(decode_cfg, params=params, device=device)

        def _engines(self):
            return [self.prefill_engine, self.decode_engine]

        def __call__(self, body: dict) -> dict:
            prompt_ids = body.get("prompt_ids", [])
            max_tokens = body.get("max_tokens")
            if max_tokens is None:
                max_tokens = 32  # explicit 0 is honored (prefill-only probe)
            t0 = time.monotonic()
            handoff = self.prefill_engine.prefill_extract(prompt_ids)
            ttft = time.monotonic() - t0
            res = self.decode_engine.attach_sequence(handoff, max_tokens).result(timeout=120)
            return {
                "token_ids": res.token_ids,
                "usage": {"prompt_tokens": res.num_prompt_tokens,
                          "completion_tokens": res.num_generated},
                "timings": {"ttft_s": ttft, "total_s": time.monotonic() - t0},
                "finish_reason": res.finish_reason,
                "disaggregated": False,
            }

        def stats(self) -> dict:
            return {"prefill": self.prefill_engine.stats(),
                    "decode": self.decode_engine.stats()}

    return PDServer.bind(cfg, prefill_config, params, device)
