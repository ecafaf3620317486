"""Paged-KV continuous-batching engine in PyTorch (port of ray_tpu/serve/llm_paged.py).

``PagedLLMEngine`` is LLMEngine's shell (scheduling, streaming, sampling,
finish and fail paths are inherited) over a block-pool KV cache:
``models.llama.forward_paged`` with the ``serve/paged_kv.py`` allocator.
Memory scales with the tokens a request reserves, and full prompt blocks
are content-addressed, so a shared prefix is prefilled once and held once.
On a CUDA device every decode step runs the hand-written paged-attention
kernel in each layer.

Admission reserves ceil((prompt + max_new) / block) pages up front, so a
decode never preempts mid-sequence.

Not yet ported: the prefill/decode handoff (``prefill_extract``,
``attach_sequence``, ``kv_transfer``) and the serve anatomy stamp.
"""

from __future__ import annotations

import dataclasses
import queue
import time
import numpy as np

from ray_tpu_torch.models import llama
from ray_tpu_torch.serve.llm import LLMConfig, LLMEngine, _Slot
from ray_tpu_torch.serve.paged_kv import BlockPool, NoFreeBlocks


@dataclasses.dataclass
class PagedLLMConfig(LLMConfig):
    block_size: int = 16
    num_blocks: int = 0  # 0 = dense-parity capacity (B * Smax / block_size)


class PagedLLMEngine(LLMEngine):
    """Continuous batching over a paged KV pool with prefix caching."""

    def __init__(self, config: PagedLLMConfig | None = None, params=None, seed: int = 0,
                 external_step: bool = False, device=None):
        self.decode_steps = 0  # batched decode steps run (each one forward_paged)
        super().__init__(config or PagedLLMConfig(), params=params, seed=seed,
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
        self.tables[i] = 0
        self.lengths[i] = 0
        self.last_tokens[i] = 0
        if self.slot_blocks[i]:
            self.allocator.free(self.slot_blocks[i])
            self.slot_blocks[i] = []

    def stats(self) -> dict:
        # the base engine's schema plus the decode count and the allocator's fields
        return {**super().stats(), "decode_steps": self.decode_steps,
                **self.allocator.stats()}

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
        self._maybe_finish(slot, tok)
        return True

    def _loop_step(self) -> bool:
        did_work = self._step_admit()
        return self._step_decode() or did_work

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
