"""An OpenAI-compatible deployment over the port's engines (copied from
ray_tpu/serve/openai_api.py): ``/v1/completions``,
``/v1/chat/completions`` (JSON or SSE chunks ending in ``data: [DONE]``) and
``/v1/models`` through the HTTP proxy.

Tokenization is pluggable: any object with encode(str)->list[int] and
decode(list[int])->str; the default is a byte-level tokenizer, so the surface
works without model assets (with random weights the text is not language,
but it is exact bytes to compare). A stream stamps its request's
``decode_first_token`` on the replica when the engine yields the first
token (serve/anatomy.py).
"""

from __future__ import annotations

import collections
import time
import uuid

from ray_tpu_torch.serve import anatomy
from ray_tpu_torch.serve.deployment import deployment as _deployment

# Deployments that opted into the OpenAI proxy surface (the proxy routes the
# /v1-style subpaths only for names registered here; other apps keep their
# plain __call__ routing).
OPENAI_DEPLOYMENT_NAMES: set[str] = {"OpenAIServer"}

# how many of the latest non-streaming requests' engine timings ``stats`` keeps
RECENT_REQUESTS = 64


class ByteTokenizer:
    """UTF-8 bytes shifted past the special ids. Ids beyond the byte range
    fold back into it (random weights sample from the full model vocab)."""

    OFFSET = 3  # 0=pad, 1=bos, 2=eos

    def encode(self, text: str) -> list[int]:
        return [b + self.OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: list[int]) -> str:
        data = bytes((i - self.OFFSET) % 256 for i in ids if i >= self.OFFSET)
        return data.decode("utf-8", errors="replace")


def _render_chat(messages: list[dict]) -> str:
    """Minimal chat template (chat templates live with the model; this is the
    fallback rendering)."""
    parts = [f"{m.get('role', 'user')}: {m.get('content', '')}" for m in messages]
    parts.append("assistant:")
    return "\n".join(parts)


def _prompt_text(body: dict) -> str:
    prompt = body.get("prompt", "")
    return "".join(prompt) if isinstance(prompt, list) else prompt


def build_openai_app(config=None, *, model_id: str = "ray-tpu-llm", tokenizer=None,
                     num_replicas: int = 1, params=None, device=None):
    """An OpenAI-API-shaped deployment: ``PagedLLMEngine`` for a
    ``PagedLLMConfig``, ``LLMEngine`` otherwise. ``params`` (the engine's
    weights, passed by reference) and ``device`` (``None``: ``cuda:0``)
    go to the engine; with ``params=None`` it draws its own seeded weights."""
    from ray_tpu_torch.serve.llm import LLMConfig

    cfg = config or LLMConfig()
    tok = tokenizer or ByteTokenizer()

    @_deployment(name="OpenAIServer", num_replicas=num_replicas,
                 ray_actor_options={"num_gpus": 0.0}, max_ongoing_requests=64)
    class OpenAIServer:
        def __init__(self, llm_config, tokenizer, model_id: str, params, device):
            from ray_tpu_torch.serve.llm import LLMEngine
            from ray_tpu_torch.serve.llm_paged import PagedLLMConfig, PagedLLMEngine

            engine = PagedLLMEngine if isinstance(llm_config, PagedLLMConfig) else LLMEngine
            self.engine = engine(llm_config, params=params, device=device)
            self.tok = tokenizer
            self.model_id = model_id
            self._recent = collections.deque(maxlen=RECENT_REQUESTS)

        def __del__(self):  # the replica is gone: stop the engine's loop
            if getattr(self, "engine", None) is not None:
                self.engine.shutdown()

        # ---- OpenAI surface ----
        def models(self, body: dict | None = None) -> dict:
            return {
                "object": "list",
                "data": [{"id": self.model_id, "object": "model", "owned_by": "ray_tpu"}],
            }

        def _generate(self, ids: list[int], max_tokens):
            res = self.engine.generate_sync(ids, max_tokens)
            self._recent.append({"ttft_s": res.ttft_s, "total_s": res.total_s,
                                 "num_generated": res.num_generated})
            return res

        def _usage(self, res) -> dict:
            return {"prompt_tokens": res.num_prompt_tokens,
                    "completion_tokens": res.num_generated,
                    "total_tokens": res.num_prompt_tokens + res.num_generated}

        def completions(self, body: dict) -> dict:
            ids = self.tok.encode(_prompt_text(body))
            res = self._generate(ids, body.get("max_tokens"))
            return {
                "id": f"cmpl-{uuid.uuid4().hex[:24]}",
                "object": "text_completion",
                "created": int(time.time()),
                "model": body.get("model", self.model_id),
                "choices": [{"index": 0, "text": self.tok.decode(res.token_ids),
                             "finish_reason": res.finish_reason, "logprobs": None}],
                "usage": self._usage(res),
            }

        def chat_completions(self, body: dict) -> dict:
            ids = self.tok.encode(_render_chat(body.get("messages", [])))
            res = self._generate(ids, body.get("max_tokens"))
            return {
                "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
                "object": "chat.completion",
                "created": int(time.time()),
                "model": body.get("model", self.model_id),
                "choices": [{"index": 0,
                             "message": {"role": "assistant",
                                         "content": self.tok.decode(res.token_ids)},
                             "finish_reason": res.finish_reason}],
                "usage": self._usage(res),
            }

        def _stream_deltas(self, ids: list[int], max_tokens, body=None):
            """Incremental detokenization: decode the whole generated id list
            each step and emit the text delta, holding back a trailing
            partial character (a multi-byte character must not split into
            replacement characters across chunks)."""
            arid = anatomy.rid_of(body)
            generated: list[int] = []
            emitted = ""
            for tok_id in self.engine.generate_stream(ids, max_tokens):
                if arid is not None:
                    # the replica's first-token clock (the proxy stamps the
                    # client's first frame after it)
                    anatomy.stamp(arid, "decode_first_token", anatomy.now_wall())
                    arid = None
                generated.append(int(tok_id))
                text = self.tok.decode(generated)
                if text.endswith("�"):
                    text = text[:-1]  # maybe an incomplete character: wait one token
                if len(text) > len(emitted):
                    delta, emitted = text[len(emitted):], text
                    yield delta
            final = self.tok.decode(generated)
            if len(final) > len(emitted):
                yield final[len(emitted):]

        def _chunk(self, rid: str, kind: str, body: dict, choice: dict) -> dict:
            return {"id": rid, "object": kind, "created": int(time.time()),
                    "model": body.get("model", self.model_id),
                    "choices": [{"index": 0, **choice}]}

        def chat_completions_stream(self, body: dict):
            """Generator of OpenAI chat chunks (SSE frames at the proxy)."""
            rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
            ids = self.tok.encode(_render_chat(body.get("messages", [])))
            for delta in self._stream_deltas(ids, body.get("max_tokens"), body):
                yield self._chunk(rid, "chat.completion.chunk", body,
                                  {"delta": {"content": delta}, "finish_reason": None})
            yield self._chunk(rid, "chat.completion.chunk", body,
                              {"delta": {}, "finish_reason": "stop"})

        def completions_stream(self, body: dict):
            rid = f"cmpl-{uuid.uuid4().hex[:24]}"
            ids = self.tok.encode(_prompt_text(body))
            for delta in self._stream_deltas(ids, body.get("max_tokens"), body):
                yield self._chunk(rid, "text_completion", body,
                                  {"text": delta, "finish_reason": None})
            yield self._chunk(rid, "text_completion", body,
                              {"text": "", "finish_reason": "stop"})

        def stats(self) -> dict:
            """The engine's counters, and under ``recent_requests`` the engine's
            ``ttft_s``/``total_s``/``num_generated`` of the latest non-streaming
            requests, oldest first (an HTTP wall minus ``total_s`` is the
            ingress's share)."""
            return {**self.engine.stats(), "recent_requests": list(self._recent)}

    return OpenAIServer.bind(cfg, tok, model_id, params, device)
