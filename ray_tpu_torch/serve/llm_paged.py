"""Paged-KV continuous-batching engine in PyTorch (port of ray_tpu/serve/llm_paged.py).

``PagedLLMEngine`` is LLMEngine's shell (scheduling, streaming, sampling,
finish and fail paths are inherited) over a block-pool KV cache:
``models.llama.forward_paged`` with the ``serve/paged_kv.py`` allocator.
Memory scales with the tokens a request reserves, and full prompt blocks
are content-addressed, so a shared prefix is prefilled once and held once.
On a CUDA device every decode step runs the hand-written paged-attention
kernel in each layer, so the constructor refuses there a model or page size
the kernel cannot take, with the kernel's own message, before any request.

Admission reserves ceil((prompt + max_new) / block) pages up front, so a
decode never preempts mid-sequence.

``prefill_extract`` / ``attach_sequence`` are the KV handoff of
prefill/decode disaggregation: a prefill engine computes a sequence's KV
pages and first token and ships them, a decode engine adopts them into its
own pool and decodes (on a CUDA device through the paged kernel). Both run
on the engine thread, in ``_step_ops``, since the pool is written in place
there. Only ``kv_transfer="host"`` is ported: the pages travel as CPU torch
tensors in the pool's layout ``[L, Hkv, n_blocks, block_size, D]``.
``attach_sequence`` also takes numpy arrays, so a float32 handoff made by
the JAX engine attaches as it is; numpy has no bfloat16, so a bf16 handoff
exists only as torch tensors.

A handoff that carries a request anatomy id (``"_rid"``) has its
``decode_first_token`` stamped by the first decode step that appends a
token for it (serve/anatomy.py). A serving replica may hand the pages over
as ``"_pulled": (kv, ack)`` in place of ``"kv"``, as the reference's decode
replica hands over what it pulled; ``ack()`` runs once they are in the
pool. The ``"device"`` and ``"plane"``
transfers raise at construction.
"""

from __future__ import annotations

import dataclasses
import queue
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import paged_attention
from ray_tpu_torch.serve import anatomy
from ray_tpu_torch.serve.llm import LLMConfig, LLMEngine, _Slot
from ray_tpu_torch.serve.paged_kv import BlockPool, NoFreeBlocks


@dataclasses.dataclass
class PagedLLMConfig(LLMConfig):
    block_size: int = 16
    num_blocks: int = 0  # 0 = dense-parity capacity (B * Smax / block_size)
    # PD handoff transport: "host" ships the KV pages as CPU tensors in the
    # handoff dict. The JAX engine's "device" (a transfer ticket) and "plane"
    # (an object-plane entry) wait for the port's runtime device hooks and
    # device-object transfer (ROADMAP queue 1 items 4 and 7).
    kv_transfer: str = "host"


class PagedLLMEngine(LLMEngine):
    """Continuous batching over a paged KV pool with prefix caching."""

    def __init__(self, config: PagedLLMConfig | None = None, params=None, seed: int = 0,
                 external_step: bool = False, device=None):
        self.decode_steps = 0  # batched decode steps run (each one forward_paged)
        config = config or PagedLLMConfig()
        if config.kv_transfer != "host":
            raise NotImplementedError(
                f"kv_transfer={config.kv_transfer!r} is not ported: only 'host' is; the "
                "'device' and 'plane' transfers wait for ROADMAP queue 1 items 4 and 7")
        # PD ops (prefill_extract / attach) processed on the engine thread
        self._ops: "queue.Queue" = queue.Queue()
        # slot -> anatomy rid awaiting its first decoded token (an attached
        # handoff's _rid); stamped and popped by the first decode step that
        # appends a token for the slot, popped unstamped when the slot is
        # released first (a 0/1-token request finishes at attach)
        self._anatomy_pending: dict = {}
        # kv_transfer="plane" binds these (KVTransport.publish / pull) once it is ported
        self.kv_publish = self.kv_pull = None
        if resolve_device(device).type == "cuda":  # before any weight is made
            cfg = config.model_config
            paged_attention.check_shape(cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                                        config.block_size)
        super().__init__(config, params=params, seed=seed,
                         external_step=external_step, device=device)

    def _init_backend(self) -> None:
        cfg = self.config.model_config
        B, S, bs = (self.config.max_batch_size, self.config.max_seq_len,
                    self.config.block_size)
        if S % bs:
            raise ValueError(f"max_seq_len {S} must be a block_size {bs} multiple")
        self.max_blocks_per_seq = S // bs
        n_blocks = self.config.num_blocks or (B * self.max_blocks_per_seq + 1)
        self.pool_blocks = n_blocks
        self.pool = llama.init_kv_pool(cfg, n_blocks, bs, self.device)
        self.allocator = BlockPool(n_blocks, bs)
        self.tables = np.zeros((B, self.max_blocks_per_seq), dtype=np.int32)
        self.slot_blocks: list[list[int]] = [[] for _ in range(B)]
        self.slot_prompts: list[Optional[list[int]]] = [None] * B

    def _prefill(self, tokens, table, start_len):
        """One sequence [1, S]: per-position logits [S, V]; pool updated in place."""
        logits, _ = llama.forward_paged(self.params, tokens, self.config.model_config,
                                        self.pool, table, start_len, self.config.block_size)
        return logits[0]

    def _decode(self, last_tokens, lengths, tables):
        logits, _ = llama.forward_paged(self.params, last_tokens, self.config.model_config,
                                        self.pool, tables, lengths, self.config.block_size)
        return logits[:, 0]

    def dummy_decode(self) -> None:
        """Cadence-keeping round for lockstep callers: decode the zeroed batch;
        inactive rows write into the reserved garbage block 0."""
        self._decode(self._tensor(self.last_tokens), self._tensor(self.lengths),
                     self._tensor(self.tables))

    # ---- slot lifecycle ----
    def _release_slot(self, i: int) -> None:
        """Free blocks AND zero the slot's rows: the batched decode scatters
        every row each step, so a stale table/length would keep writing into
        blocks after they're reallocated to other sequences (silent KV
        corruption). Zeroed rows write into reserved garbage block 0."""
        super()._release_slot(i)
        self._anatomy_pending.pop(i, None)
        self.tables[i] = 0
        self.lengths[i] = 0
        self.last_tokens[i] = 0
        if self.slot_blocks[i]:
            self.allocator.free(self.slot_blocks[i])
            self.slot_blocks[i] = []
        self.slot_prompts[i] = None

    def stats(self) -> dict:
        # the base engine's schema plus the decode count and the allocator's fields
        return {**super().stats(), "decode_steps": self.decode_steps,
                **self.allocator.stats()}

    def shutdown(self) -> None:
        super().shutdown()  # stops the loop + fails active slots
        # drain queued PD ops so their callers fail fast instead of timing out
        while True:
            try:
                _, _, fut = self._ops.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("LLM engine shut down"))

    def kv_memory_bytes(self) -> int:
        """Persistent KV pool footprint (the headroom metric vs dense)."""
        cfg = self.config.model_config
        return (2 * cfg.num_layers * self.pool_blocks * self.config.block_size
                * cfg.num_kv_heads * cfg.hd * cfg.dtype.itemsize)

    # ---- engine loop ----
    def _admit_one(self, prompt, max_new, fut, t_enq, tq, slot) -> bool:
        bs = self.config.block_size
        total_blocks = -(-(len(prompt) + max_new) // bs)
        if total_blocks > self.pool_blocks - 1:
            # can never fit this pool: reject now rather than requeue forever
            if not fut.done():
                fut.set_exception(ValueError(
                    f"request needs {total_blocks} KV blocks but the pool has "
                    f"{self.pool_blocks - 1}; raise num_blocks or shorten the request"
                ))
            if tq is not None:
                tq.put(None)
            return True
        hit_ids, cached_len = self.allocator.lookup_prefix(prompt)
        if cached_len >= len(prompt):
            # whole prompt block-aligned-cached: recompute the last block so
            # we still have logits to sample the first token from
            self.allocator.free([hit_ids.pop()])
            cached_len -= bs
        try:
            fresh = self.allocator.alloc(total_blocks - len(hit_ids))
        except NoFreeBlocks:
            for b in hit_ids:
                self.allocator.free([b])
            return False  # requeue: capacity frees as sequences finish
        block_ids = hit_ids + fresh
        suffix = prompt[cached_len:]
        # clamp the prefill bucket so padded positions stay inside the table
        bucket = min(self._bucket(len(suffix)),
                     self.config.max_seq_len - cached_len)
        padded = np.zeros((1, bucket), dtype=np.int32)
        padded[0, : len(suffix)] = suffix
        table_row = np.zeros((1, self.max_blocks_per_seq), dtype=np.int32)
        table_row[0, : len(block_ids)] = block_ids
        try:
            logits = self._prefill(self._tensor(padded), self._tensor(table_row),
                                   self._tensor(np.asarray([cached_len], np.int32)))
            tok = self._sample(logits[len(suffix) - 1].cpu().numpy())
        except Exception as e:  # noqa: BLE001 - bad request: fail, keep serving
            self.allocator.free(block_ids)
            if not fut.done():
                fut.set_exception(e)
            if tq is not None:
                tq.put(None)
            return True
        self.allocator.register_prefix(prompt, block_ids,
                                       skip_blocks=cached_len // bs)
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
            self.tables[slot] = table_row[0]
            self.slot_blocks[slot] = block_ids
            self.slot_prompts[slot] = list(prompt)
        self._maybe_finish(slot, tok)
        return True

    def _loop_step(self) -> bool:
        did_work = self._step_ops()
        did_work = self._step_admit() or did_work
        return self._step_decode() or did_work

    def _step_ops(self) -> bool:
        did_work = False
        for _ in range(self._ops.qsize()):  # bounded: attach may requeue itself
            try:
                kind, payload, fut = self._ops.get_nowait()
            except queue.Empty:
                break
            try:
                if kind == "prefill_extract":
                    fut.set_result(self._do_prefill_extract(payload))
                else:
                    self._do_attach(payload, fut)
            except Exception as e:  # noqa: BLE001
                if not fut.done():
                    fut.set_exception(e)
            did_work = True
        return did_work

    def _step_admit(self) -> bool:
        did_work = False
        free = [i for i in range(self.config.max_batch_size) if not self.active[i]]
        requeue = []
        while free and not self._pending.empty():
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            slot = free.pop(0)
            if not self._admit_one(*req, slot):
                requeue.append(req)
                free.insert(0, slot)
                break  # pool exhausted: stop admitting this pass
            did_work = True
        for req in requeue:
            self._pending.put(req)
        return did_work

    def _step_decode(self) -> bool:
        if not self.active.any():
            return False
        logits = self._decode(self._tensor(self.last_tokens), self._tensor(self.lengths),
                              self._tensor(self.tables))
        self.decode_steps += 1
        self._append_decoded(logits.cpu().numpy())
        return True

    def _on_decoded(self) -> None:
        if self._anatomy_pending:
            t_w = anatomy.now_wall()
            for i in list(self._anatomy_pending):
                if self.active[i]:
                    anatomy.stamp(self._anatomy_pending.pop(i), "decode_first_token", t_w)

    # ---- PD disaggregation handoff ----
    def prefill_extract(self, prompt_ids: list[int], timeout: float = 120.0) -> dict:
        """Prefill-only: compute the prompt's KV pages and first token, then
        release local blocks. Returns a handoff payload for attach_sequence."""
        fut: Future = Future()
        self._ops.put(("prefill_extract", list(prompt_ids), fut))
        return fut.result(timeout=timeout)

    def attach_sequence(self, handoff: dict, max_new_tokens: int) -> Future:
        """Adopt a prefilled sequence (KV pages + first token) and decode it
        (the decode half of PD disaggregation)."""
        fut: Future = Future()
        self._ops.put(("attach", (handoff, max_new_tokens), fut))
        return fut

    def _do_prefill_extract(self, prompt_ids: list[int]) -> dict:
        bs = self.config.block_size
        err = self._validate(prompt_ids, 1)
        if err is not None:
            raise err
        n_blocks = -(-len(prompt_ids) // bs)
        block_ids = self.allocator.alloc(n_blocks)
        padded_len = min(self._bucket(len(prompt_ids)), self.config.max_seq_len)
        padded = np.zeros((1, padded_len), dtype=np.int32)
        padded[0, : len(prompt_ids)] = prompt_ids
        table_row = np.zeros((1, self.max_blocks_per_seq), dtype=np.int32)
        table_row[0, :n_blocks] = block_ids
        try:
            logits = self._prefill(self._tensor(padded), self._tensor(table_row),
                                   self._tensor(np.asarray([0], np.int32)))
            first_tok = self._sample(logits[len(prompt_ids) - 1].cpu().numpy())
            idx = torch.as_tensor(block_ids, device=self.device)
            kv = {"k": self.pool["k"][:, :, idx].cpu(),  # [L, Hkv, n, BS, D]
                  "v": self.pool["v"][:, :, idx].cpu()}
        finally:
            self.allocator.free(block_ids)
        return {
            "kv": kv,
            "kv_ticket": None,
            "kv_ref": None,
            "n_prefill_blocks": len(block_ids),
            "first_token": first_tok,
            "prompt_len": len(prompt_ids),
            # lets draft-model engines (spec decode) rebuild their own KV
            "prompt_ids": list(prompt_ids),
        }

    def _do_attach(self, payload, fut: Future) -> Optional[int]:
        handoff, max_new_tokens = payload
        prompt_len = handoff["prompt_len"]
        bs = self.config.block_size
        if prompt_len <= 0:
            raise ValueError("handoff prompt_len must be positive")
        if prompt_len + max_new_tokens > self.config.max_seq_len:
            raise ValueError(
                f"attached sequence ({prompt_len}+{max_new_tokens}) exceeds "
                f"max_seq_len {self.config.max_seq_len}"
            )
        with self._lock:
            slot = next(
                (i for i in range(self.config.max_batch_size)
                 if not self.active[i] and self.slots[i] is None), None,
            )
        if slot is None:
            # decode side saturated: requeue the op for a later pass
            self._ops.put(("attach", payload, fut))
            return None
        kv, ack = handoff.get("kv"), None
        pulled = handoff.get("_pulled")
        if kv is None and pulled is not None:
            # pages a serving replica holds for this request, with the
            # callback that releases them, fired once they land in the pool
            # (serve/pd.py's decode side counts its live handoffs by it)
            kv, ack = pulled
        if kv is None:
            raise NotImplementedError(
                "the handoff carries no host KV pages ('kv'): the 'device' and 'plane' "
                "transfers wait for ROADMAP queue 1 items 4 and 7")
        # torch tensors from this engine, or numpy arrays (read-only when
        # exported by jax, hence the copy) from the JAX engine
        k, v = ((kv[n] if isinstance(kv[n], torch.Tensor) else torch.from_numpy(np.array(kv[n])))
                .to(self.device, self.pool[n].dtype) for n in ("k", "v"))
        n_prefill_blocks = k.shape[2]
        table = handoff.get("block_table")
        if table is not None and len(table) != n_prefill_blocks:
            # the block table is the page-order contract for the transferred
            # entry, so its length must match what actually arrived
            raise ValueError(
                f"KV handoff block_table lists {len(table)} pages but the "
                f"transferred entry carries {n_prefill_blocks}")
        total_blocks = -(-(prompt_len + max_new_tokens) // bs)
        block_ids = self.allocator.alloc(total_blocks)
        try:
            idx = torch.as_tensor(block_ids[:n_prefill_blocks], device=self.device)
            self.pool["k"][:, :, idx] = k
            self.pool["v"][:, :, idx] = v
            with self._lock:
                st = _Slot(fut, max_new_tokens, prompt_len, time.monotonic())
                st.generated.append(handoff["first_token"])
                st.first_token_time = time.monotonic()
                self.slots[slot] = st
                self.active[slot] = True
                self.lengths[slot] = prompt_len
                self.last_tokens[slot, 0] = handoff["first_token"]
                row = np.zeros(self.max_blocks_per_seq, dtype=np.int32)
                row[: len(block_ids)] = block_ids
                self.tables[slot] = row
                self.slot_blocks[slot] = block_ids
        except BaseException:
            self.allocator.free(block_ids)
            raise
        if ack is not None:
            ack()  # the pages landed in the pool
        rid = handoff.get("_rid")
        if rid is not None:
            self._anatomy_pending[slot] = rid
        # a 1-token (or 0-token) request is already complete with first_token
        self._maybe_finish(slot, handoff["first_token"])
        return slot
