"""Continuous-batching LLM engine in PyTorch (port of ray_tpu/serve/llm.py).

Same shell as the JAX engine: slots that requests join and leave between
batched decode steps, a loop thread (or ``step_once`` under external
control), streaming, cancelling and failure paths. The dense backend keeps a
per-slot KV cache and runs ``models.llama.forward_with_cache``; the paged
engine (``llm_paged.py``) replaces it. PyTorch runs eagerly, so there is no
jit; the cache is updated in place.

Sampling keeps the JAX engine's semantics: greedy is ``np.argmax`` over the
host copy of the logits (ties break the same way); temperature sampling
draws from the engine's own ``np.random.default_rng(seed)``.

``build_llm_deployment`` serves the engine through the serve control plane
(``serve/controller.py``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import llama


@dataclasses.dataclass
class LLMConfig:
    model_config: llama.LlamaConfig = dataclasses.field(default_factory=llama.LlamaConfig.tiny)
    max_batch_size: int = 8
    max_seq_len: int = 256
    max_new_tokens_default: int = 32
    temperature: float = 0.0  # 0 = greedy
    eos_token_id: int = -1  # -1: never stop early (random-weight demo mode)
    prefill_buckets: tuple = (32, 128)


@dataclasses.dataclass
class GenerationResult:
    token_ids: list
    num_prompt_tokens: int
    num_generated: int
    ttft_s: float
    total_s: float
    finish_reason: str = "length"


class _Slot:
    __slots__ = ("future", "max_new", "generated", "start", "first_token_time",
                 "prompt_len", "token_queue")

    def __init__(self, future, max_new, prompt_len, enqueue_time, token_queue=None):
        self.future = future
        self.max_new = max_new
        self.generated = []
        self.start = enqueue_time  # TTFT measured from request arrival, incl. queueing
        self.first_token_time = None
        self.prompt_len = prompt_len
        self.token_queue = token_queue  # streaming consumers get tokens as decoded


class LLMEngine:
    """Continuous-batching generation engine on one device.

    ``device=None`` means the first CUDA device and raises without one;
    pass ``device="cpu"`` to run on the CPU. ``params=None`` draws random
    weights from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, config: LLMConfig, params=None, seed: int = 0,
                 external_step: bool = False, device=None):
        self.config = config
        cfg = config.model_config
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = llama.init(cfg, gen, self.device)
        self.params = params
        B = config.max_batch_size
        self.lengths = np.zeros(B, dtype=np.int32)
        self.last_tokens = np.zeros((B, 1), dtype=np.int32)
        self.active = np.zeros(B, dtype=bool)
        self.slots: list[Optional[_Slot]] = [None] * B
        self._pending: "queue.Queue[tuple[list[int], int, Future, float]]" = queue.Queue()
        self._lock = threading.Lock()
        self._running = True
        self._rng = np.random.default_rng(seed)
        self._init_backend()  # subclass hook: cache/pool
        # external_step: no internal loop thread — a coordinator drives the
        # engine via step_once()
        self._loop_thread = None
        if not external_step:
            self._loop_thread = threading.Thread(target=self._loop, daemon=True,
                                                 name=type(self).__name__)
            self._loop_thread.start()

    def step_once(self) -> bool:
        """One admit/decode round under external control; True if work ran."""
        try:
            return self._loop_step()
        except Exception as e:  # noqa: BLE001 - engine must survive any request
            self._fail_all_active(e)
            return True

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _init_backend(self) -> None:
        """Dense per-slot KV cache backend (paged subclass overrides)."""
        cfg = self.config.model_config
        B, S = self.config.max_batch_size, self.config.max_seq_len
        self.cache = llama.init_kv_cache(cfg, B, S, self.device)

    def _prefill(self, tokens, slot: int, length: int):
        """Run one right-padded prompt [1, bucket] into ``slot``'s cache rows
        (views, written in place); logits at the last real prompt position."""
        cfg = self.config.model_config
        sub = {"k": self.cache["k"][:, slot:slot + 1], "v": self.cache["v"][:, slot:slot + 1]}
        zero = torch.zeros(1, dtype=torch.int32, device=self.device)
        logits, _ = llama.forward_with_cache(self.params, tokens, cfg, sub, zero)
        return logits[0, length - 1]

    def _decode(self, last_tokens, lengths):
        logits, _ = llama.forward_with_cache(self.params, last_tokens,
                                             self.config.model_config, self.cache, lengths)
        return logits[:, 0]

    # ---- public API ----
    def _validate(self, prompt_ids, max_new) -> Optional[Exception]:
        if not prompt_ids:
            return ValueError("prompt_ids must be non-empty")
        vocab = self.config.model_config.vocab_size
        if not all(isinstance(t, (int, np.integer)) and 0 <= t < vocab
                   for t in prompt_ids):
            return ValueError("prompt_ids must be ints within the vocabulary")
        if len(prompt_ids) + max_new > self.config.max_seq_len:
            return ValueError(
                f"prompt ({len(prompt_ids)}) + max_new_tokens ({max_new}) exceeds "
                f"max_seq_len {self.config.max_seq_len}"
            )
        return None

    def generate(self, prompt_ids: list[int], max_new_tokens: int | None = None) -> Future:
        fut: Future = Future()
        max_new = self.config.max_new_tokens_default if max_new_tokens is None else max_new_tokens
        err = self._validate(prompt_ids, max_new)
        if err is not None:
            fut.set_exception(err)
            return fut
        if max_new <= 0:
            fut.set_result(GenerationResult([], len(prompt_ids), 0, 0.0, 0.0))
            return fut
        self._pending.put((list(prompt_ids), max_new, fut, time.monotonic(), None))
        return fut

    def generate_stream(self, prompt_ids: list[int], max_new_tokens: int | None = None):
        """Yield token ids as they are decoded. Every engine path (completion,
        request failure, engine failure, shutdown) ends the stream with the
        None sentinel, so consumers never hang."""
        fut: Future = Future()
        max_new = self.config.max_new_tokens_default if max_new_tokens is None else max_new_tokens
        err = self._validate(prompt_ids, max_new)
        if err is not None:
            raise err
        if max_new <= 0:
            return
        tq: "queue.Queue" = queue.Queue()
        self._pending.put((list(prompt_ids), max_new, fut, time.monotonic(), tq))
        while True:
            item = tq.get(timeout=300)
            if item is None:
                if fut.done() and fut.exception() is not None:
                    raise fut.exception()
                return
            yield item

    def generate_sync(self, prompt_ids: list[int], max_new_tokens: int | None = None,
                      timeout: float = 120.0) -> GenerationResult:
        return self.generate(prompt_ids, max_new_tokens).result(timeout)

    def stats(self) -> dict:
        with self._lock:
            return {
                "active_slots": int(self.active.sum()),
                "max_slots": self.config.max_batch_size,
                "pending": self._pending.qsize(),
            }

    def shutdown(self) -> None:
        """Stop the loop (waiting for the step in flight, so no kernel is
        launched after this returns) and fail the active requests."""
        self._running = False
        if self._loop_thread is not None and self._loop_thread is not threading.current_thread():
            self._loop_thread.join(timeout=60)
        self._fail_all_active(RuntimeError("LLM engine shut down"))

    # ---- engine loop ----
    def _bucket(self, n: int) -> int:
        for b in self.config.prefill_buckets:
            if n <= b:
                return b
        return self.config.max_seq_len

    def _sample(self, logits_np: np.ndarray) -> int:
        if self.config.temperature <= 0:
            return int(np.argmax(logits_np))
        z = logits_np / self.config.temperature
        z = z - z.max()
        p = np.exp(z) / np.exp(z).sum()
        return int(self._rng.choice(len(p), p=p))

    def _loop(self) -> None:
        while self._running:
            try:
                did_work = self._loop_step()
            except Exception as e:  # noqa: BLE001 - engine must survive any request
                self._fail_all_active(e)
                did_work = True
            if not did_work:
                time.sleep(0.002)

    def _release_slot(self, i: int) -> None:
        """Free a slot's resources (paged subclass also returns KV blocks and
        zeroes the slot's table row)."""
        self.active[i] = False
        self.slots[i] = None

    def cancel_future(self, fut) -> bool:
        """Cancel the in-flight request whose slot holds `fut`: release the
        slot (and its KV blocks, in the paged engine) under the engine lock.
        Returns False if the future holds no slot (finished or still queued)."""
        with self._lock:
            for i, st in enumerate(self.slots):
                if st is not None and st.future is fut:
                    self._release_slot(i)
                    return True
        return False

    def _fail_all_active(self, exc: Exception) -> None:
        with self._lock:
            for i in range(self.config.max_batch_size):
                st = self.slots[i]
                if st is not None:
                    self._release_slot(i)
                    if not st.future.done():
                        st.future.set_exception(exc)
                    if st.token_queue is not None:
                        st.token_queue.put(None)

    def _loop_step(self) -> bool:
        did_work = False
        # 1) admit pending requests into free slots (prefill)
        free = [i for i in range(self.config.max_batch_size) if not self.active[i]]
        while free and not self._pending.empty():
            try:
                prompt, max_new, fut, t_enq, tq = self._pending.get_nowait()
            except queue.Empty:
                break
            slot = free.pop(0)
            try:
                bucket = self._bucket(len(prompt))
                padded = np.zeros((1, bucket), dtype=np.int32)
                padded[0, : len(prompt)] = prompt
                last_logits = self._prefill(self._tensor(padded), slot, len(prompt))
                tok = self._sample(last_logits.cpu().numpy())
            except Exception as e:  # noqa: BLE001 - bad request: fail it, keep serving
                if not fut.done():
                    fut.set_exception(e)
                if tq is not None:
                    tq.put(None)  # terminate any streaming consumer
                free.insert(0, slot)
                continue
            with self._lock:
                st = _Slot(fut, max_new, len(prompt), t_enq, tq)
                st.generated.append(tok)
                if tq is not None:
                    tq.put(tok)
                st.first_token_time = time.monotonic()
                self.slots[slot] = st
                self.active[slot] = True
                self.lengths[slot] = len(prompt)
                self.last_tokens[slot, 0] = tok
            did_work = True
            self._maybe_finish(slot, tok)
        # 2) batched decode step for all active slots
        if self.active.any():
            logits = self._decode(self._tensor(self.last_tokens), self._tensor(self.lengths))
            self._append_decoded(logits.cpu().numpy())
            did_work = True
        return did_work

    def _append_decoded(self, logits_np: np.ndarray) -> None:
        """Sample one token for every active row of a decode step's logits
        and finish the requests that are done."""
        with self._lock:
            for i in range(self.config.max_batch_size):
                if not self.active[i]:
                    continue
                tok = self._sample(logits_np[i])
                st = self.slots[i]
                st.generated.append(tok)
                if st.token_queue is not None:
                    st.token_queue.put(tok)
                self.lengths[i] += 1
                self.last_tokens[i, 0] = tok
        self._on_decoded()
        for i in range(self.config.max_batch_size):
            if self.active[i]:
                self._maybe_finish(i, self.slots[i].generated[-1])

    def _on_decoded(self) -> None:
        """Called once a decode step's tokens are appended, before any
        request of the step is finished (a subclass's stamp point)."""

    def _maybe_finish(self, slot: int, last_tok: int) -> None:
        st = self.slots[slot]
        if st is None:
            return
        eos = self.config.eos_token_id >= 0 and last_tok == self.config.eos_token_id
        if eos or len(st.generated) >= st.max_new:
            now = time.monotonic()
            result = GenerationResult(
                token_ids=list(st.generated),
                num_prompt_tokens=st.prompt_len,
                num_generated=len(st.generated),
                ttft_s=(st.first_token_time or now) - st.start,
                total_s=now - st.start,
                finish_reason="stop" if eos else "length",
            )
            with self._lock:
                self._release_slot(slot)
            if st.token_queue is not None:
                st.token_queue.put(None)  # end-of-stream
            if not st.future.done():
                st.future.set_result(result)


# ------------------------------------------------------------------ serve glue
def build_llm_deployment(config: LLMConfig | None = None, num_replicas: int = 1, *,
                         params=None, device=None):
    """An LLMServer deployment. POST body: {"prompt_ids": [...], "max_tokens":
    N} -> token ids, usage and timings. ``params`` (passed by reference) and
    ``device`` (``None``: ``cuda:0``) go to the engine."""
    from ray_tpu_torch.serve.deployment import deployment

    cfg = config or LLMConfig()

    @deployment(name="LLMServer", num_replicas=num_replicas,
                ray_actor_options={"num_gpus": 0.0})
    class LLMServer:
        def __init__(self, llm_config: LLMConfig, params, device):
            self.engine = LLMEngine(llm_config, params=params, device=device)

        def __del__(self):  # the replica is gone: stop the engine's loop
            if getattr(self, "engine", None) is not None:
                self.engine.shutdown()

        def __call__(self, body: dict) -> dict:
            res = self.engine.generate_sync(body.get("prompt_ids", []), body.get("max_tokens"))
            return {
                "token_ids": res.token_ids,
                "usage": {"prompt_tokens": res.num_prompt_tokens,
                          "completion_tokens": res.num_generated},
                "timings": {"ttft_s": res.ttft_s, "total_s": res.total_s},
                "finish_reason": res.finish_reason,
            }

        def stats(self) -> dict:
            return self.engine.stats()

        def stream_tokens(self, body: dict):
            """Generator: one token id per yield (serve streaming path)."""
            yield from self.engine.generate_stream(body.get("prompt_ids", []),
                                                   body.get("max_tokens"))

    return LLMServer.bind(cfg, params, device)
