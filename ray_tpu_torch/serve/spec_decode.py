"""Speculative decoding over the paged-KV engine in PyTorch (port of
ray_tpu/serve/spec_decode.py).

A small draft model proposes K tokens autoregressively, then the target
model scores all K+1 positions in ONE batched paged forward: the verify
step is a [B, K+1] window instead of K+1 sequential [B, 1] decodes. On a
CUDA device the draft's single-token decodes run the paged-attention kernel
at the draft's shape; the two-token draft window and the verify window take
the gather path, as every ``forward_paged`` call with S > 1 does.

Greedy invariant: with temperature 0 the committed output is exactly the
target model's greedy decode whatever the draft: a bad draft only costs
speed (acceptance falls toward 1 committed token a step), never
correctness. Both KV pools share one block allocator: the draft pool
mirrors the target pool's block ids, so a sequence's table row addresses
its pages in both.

Rejected positions: verify writes target KV for all K+1 window positions;
committing only a prefix leaves stale KV at later positions, which the
causal position mask already excludes, and the next window overwrites them
(the same holds for the draft pool).

Only the argmax indices of the draft and verify logits come back to the
host, once a step; the JAX engine copies the whole [B, K+1, V] logits,
with the same result.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import paged_attention
from ray_tpu_torch.serve.llm_paged import PagedLLMConfig, PagedLLMEngine


@dataclasses.dataclass
class SpecDecodeConfig(PagedLLMConfig):
    draft_model_config: Optional[llama.LlamaConfig] = None
    num_speculative_tokens: int = 4


class SpecDecodeLLMEngine(PagedLLMEngine):
    """Draft-propose / target-verify continuous batching (greedy sampling).

    ``draft_params=None`` draws the draft's weights from a
    ``torch.Generator`` seeded with 7 on the engine's device. On a CUDA
    device the constructor refuses a draft model the paged kernel cannot
    take, as ``PagedLLMEngine`` does for the target."""

    def __init__(self, config: SpecDecodeConfig, params=None, draft_params=None,
                 seed: int = 0, device=None):
        if config.draft_model_config is None:
            raise ValueError("SpecDecodeConfig.draft_model_config is required")
        if config.num_speculative_tokens < 1:
            raise ValueError("num_speculative_tokens must be >= 1")
        if config.temperature > 0:
            raise ValueError(
                "speculative decoding implements the greedy acceptance rule; "
                "temperature must be 0"
            )
        dm, tm = config.draft_model_config, config.model_config
        if dm.vocab_size != tm.vocab_size:
            raise ValueError("draft and target models must share a vocabulary")
        if resolve_device(device).type == "cuda":  # before any weight is made
            paged_attention.check_shape(dm.num_heads, dm.num_kv_heads, dm.hd,
                                        config.block_size)
        self._draft_params_init = draft_params
        self.proposed_tokens = 0  # draft proposals inside their request's budget
        self.accepted_tokens = 0  # of those, the ones the verify step accepted
        super().__init__(config, params=params, seed=seed, device=device)

    def _init_backend(self) -> None:
        super()._init_backend()
        dcfg = self.config.draft_model_config
        if self._draft_params_init is None:
            gen = torch.Generator(device=self.device).manual_seed(7)
            self.draft_params = llama.init(dcfg, gen, self.device)
        else:
            self.draft_params = self._draft_params_init
        # mirror pool: same block ids resolve in both pools via one table
        self.draft_pool = llama.init_kv_pool(dcfg, self.pool_blocks, self.config.block_size,
                                             self.device)
        # second-to-last committed token per slot (the 2-token window's head)
        self.prev_tokens = np.zeros((self.config.max_batch_size, 1), dtype=np.int32)

    def _draft_forward(self, tokens, lengths, tables):
        """The draft model over [B, S] tokens appended at ``lengths``; the
        draft pool is written in place. Logits [B, S, V]."""
        logits, _ = llama.forward_paged(self.draft_params, tokens,
                                        self.config.draft_model_config, self.draft_pool,
                                        tables, lengths, self.config.block_size)
        return logits

    def stats(self) -> dict:
        return {**super().stats(), "proposed_tokens": self.proposed_tokens,
                "accepted_tokens": self.accepted_tokens}

    # ---- admission: also prefill the DRAFT pool for the slot ----
    def _admit_one(self, prompt, max_new, fut, t_enq, tq, slot) -> bool:
        admitted = super()._admit_one(prompt, max_new, fut, t_enq, tq, slot)
        if not admitted or not self.active[slot]:
            # not admitted, rejected, or already finished (max_new reached)
            return admitted
        try:
            self._draft_prefill_slot(slot, prompt)
        except Exception as e:  # noqa: BLE001 - fail THIS request, keep serving
            st = self.slots[slot]
            with self._lock:
                self._release_slot(slot)
            if st is not None:
                if not st.future.done():
                    st.future.set_exception(e)
                if st.token_queue is not None:
                    st.token_queue.put(None)
        return True

    def _draft_prefill_slot(self, slot: int, prompt) -> None:
        """Draft-prefill the WHOLE prompt (start 0): independent of the
        target's prefix-cache skip, and shared prefix blocks get identical
        draft KV rewritten, so sharing stays sound."""
        bucket = min(self._bucket(len(prompt)), self.config.max_seq_len)
        padded = np.zeros((1, bucket), dtype=np.int32)
        padded[0, : len(prompt)] = prompt
        self._draft_forward(self._tensor(padded), self._tensor(np.zeros(1, np.int32)),
                            self._tensor(self.tables[slot][None, :]))
        self.prev_tokens[slot, 0] = prompt[-1]

    def _release_slot(self, i: int) -> None:
        super()._release_slot(i)
        self.prev_tokens[i] = 0

    def _do_attach(self, payload, fut):
        """PD attach: also rebuild this sequence's DRAFT KV from the prompt
        ids carried in the handoff; without it acceptance collapses to ~0 and
        the decode half of PD becomes slower than plain paged decode."""
        handoff, _ = payload
        prompt_ids = handoff.get("prompt_ids")
        if not prompt_ids:
            raise NotImplementedError(
                "speculative decode attach requires 'prompt_ids' in the "
                "handoff (produced by prefill_extract)"
            )
        slot = super()._do_attach(payload, fut)
        if slot is not None and self.active[slot]:
            self._draft_prefill_slot(slot, prompt_ids)
        return slot

    # ---- decode: propose K draft tokens, verify in one target pass ----
    def _step_decode(self) -> bool:
        if not self.active.any():
            return False
        K = self.config.num_speculative_tokens
        B = self.config.max_batch_size
        base_lengths = self.lengths.copy()
        # tables/lengths do not change within a step: upload them once and
        # derive the shifted lengths on the device
        tables_dev = self._tensor(self.tables)
        base_dev = self._tensor(base_lengths)
        # first draft step: the [prev, last] 2-token window fills any
        # bonus-token draft-KV hole from a fully-accepted prior step, and its
        # last logits propose p1
        window2 = self._tensor(np.concatenate([self.prev_tokens, self.last_tokens], axis=1))
        dlogits = self._draft_forward(window2, (base_dev - 1).clamp(min=0), tables_dev)
        cur = dlogits[:, 1].argmax(-1, keepdim=True).int()  # [B, 1], stays on the device
        proposed = [cur]
        for k in range(1, K):
            cur = self._draft_forward(cur, base_dev + k, tables_dev)[:, 0].argmax(
                -1, keepdim=True).int()
            proposed.append(cur)
        window = torch.cat([self._tensor(self.last_tokens)] + proposed, dim=1)  # [B, K+1]
        logits, _ = llama.forward_paged(self.params, window, self.config.model_config,
                                        self.pool, tables_dev, base_dev,
                                        self.config.block_size)
        self.decode_steps += 1
        # one device-to-host copy a step: the proposals and the target's choices
        both = torch.cat([window[:, 1:], logits.argmax(-1).int()], dim=1).cpu().numpy()
        proposals, target_preds = both[:, :K], both[:, K:]  # [B, K], [B, K+1]
        finished = []
        with self._lock:
            for i in range(B):
                if not self.active[i]:
                    continue
                st = self.slots[i]
                # accept proposals while they match the target's greedy choice
                a = 0
                while a < K and proposals[i, a] == target_preds[i, a]:
                    a += 1
                committed = list(proposals[i, :a]) + [int(target_preds[i, a])]
                remaining = st.max_new - len(st.generated)
                # proposals past the request's budget are never committed (and
                # past its pages they read the garbage block): not counted
                self.proposed_tokens += min(K, remaining)
                self.accepted_tokens += min(a, remaining)
                committed = committed[: max(0, remaining)]
                eos = self.config.eos_token_id
                if eos >= 0 and eos in committed:
                    committed = committed[: committed.index(eos) + 1]
                for tok in committed:
                    st.generated.append(int(tok))
                    if st.token_queue is not None:
                        st.token_queue.put(int(tok))
                self.lengths[i] = base_lengths[i] + len(committed)
                if len(committed) >= 2:
                    self.prev_tokens[i, 0] = committed[-2]
                elif committed:
                    self.prev_tokens[i, 0] = self.last_tokens[i, 0]
                if committed:
                    self.last_tokens[i, 0] = committed[-1]
                finished.append(i)
        for i in finished:
            if self.active[i]:
                self._maybe_finish(i, self.slots[i].generated[-1])
        return True
