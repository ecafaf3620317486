"""The port's LLM apps over HTTP against the JAX servers, on the same
weights: ray_tpu_torch's ``build_openai_app`` and ``build_llm_deployment``,
served on the CPU through ``serve.run`` and the HTTP proxy, with the JAX
package's OpenAIServer and LLMServer built in-process (their deployment's
class called directly, no JAX runtime) and their weights converted by
``llama.from_jax``. Greedy decoding on LlamaConfig.tiny() in float32, so
text, usage and token ids must be equal exactly, for the dense and the paged
engine; SSE chunks must join to the same text.

Every proxy binds port 0, every request and get has a timeout, and every
test runs under a deadline of its own (SIGALRM); teardown shuts serve and
the runtime down and checks that no non-daemon thread is left."""

import json
import signal
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models import llama as jl
from ray_tpu.serve import llm as jllm
from ray_tpu.serve import llm_paged as jpaged
from ray_tpu.serve import openai_api as jopenai
from ray_tpu_torch import serve
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve.llm import LLMConfig
from ray_tpu_torch.serve.llm_paged import PagedLLMConfig

DEADLINE_S = 60
MAX_TOKENS = 10
COMPLETIONS = [{"prompt": "The quick brown fox", "max_tokens": MAX_TOKENS},
               {"prompt": ["paged ", "attention ", "on Hopper, " * 4], "max_tokens": MAX_TOKENS},
               {"prompt": "x", "max_tokens": 3}]
CHATS = [{"messages": [{"role": "system", "content": "be brief"},
                       {"role": "user", "content": "hello there"}], "max_tokens": MAX_TOKENS},
         {"messages": [{"role": "user", "content": "why " * 20}], "max_tokens": MAX_TOKENS}]


@pytest.fixture(autouse=True)
def _guard():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    before = set(threading.enumerate())
    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, DEADLINE_S)
    try:
        rt.init(num_cpus=8, num_gpus=0)
        yield
    finally:
        try:
            serve.shutdown()
            rt.shutdown()
            left = [t for t in threading.enumerate()
                    if t not in before and t.is_alive() and not t.daemon]
            assert not left, left
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)


def _configs(kind: str):
    """(JAX config, torch config) of one engine kind at the tiny size."""
    common = dict(max_batch_size=4, max_seq_len=128)
    if kind == "paged":
        return (jpaged.PagedLLMConfig(model_config=jl.LlamaConfig.tiny(), block_size=16,
                                      **common),
                PagedLLMConfig(model_config=tl.LlamaConfig.tiny(), block_size=16, **common))
    return (jllm.LLMConfig(model_config=jl.LlamaConfig.tiny(), **common),
            LLMConfig(model_config=tl.LlamaConfig.tiny(), **common))


def _in_process(app):
    """The JAX app's server object, built as its replica would build it."""
    dep = app.deployment
    return dep.func_or_class(*dep.init_args, **dep.init_kwargs)


def _torch_params(jax_engine, cfg) -> dict:
    return tl.from_jax(jax.tree.map(np.asarray, jax_engine.params), cfg, "cpu")


@pytest.fixture(scope="module", params=["dense", "paged"])
def jax_openai(request):
    """(kind, torch config, the JAX server's answers, converted weights)."""
    jcfg, tcfg = _configs(request.param)
    server = _in_process(jopenai.build_openai_app(jcfg))
    try:
        want = {"completions": [server.completions(b) for b in COMPLETIONS],
                "chat": [server.chat_completions(b) for b in CHATS]}
        params = _torch_params(server.engine, tcfg.model_config)
    finally:
        server.engine.shutdown()
    return request.param, tcfg, want, params


def _post(port: int, path: str, body: dict):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        if r.headers["Content-Type"].startswith("text/event-stream"):
            frames = [ln.decode().strip() for ln in r if ln.strip()]
            assert frames[-1] == "data: [DONE]"
            return [json.loads(f[len("data: "):]) for f in frames[:-1]]
        return json.loads(r.read())


def _serve_openai(tcfg, params) -> int:
    serve.run(serve.build_openai_app(tcfg, params=params, device="cpu"), route_prefix="/v1")
    return serve.start_http_proxy(port=0).port


def test_openai_app_gives_the_jax_servers_answers(jax_openai):
    kind, tcfg, want, params = jax_openai
    port = _serve_openai(tcfg, params)
    for body, w in zip(COMPLETIONS, want["completions"]):
        got = _post(port, "/v1/completions", body)
        assert got["object"] == "text_completion"
        assert got["choices"][0]["text"] == w["choices"][0]["text"], (kind, body)
        assert got["choices"][0]["finish_reason"] == w["choices"][0]["finish_reason"]
        assert got["usage"] == w["usage"]
    for body, w in zip(CHATS, want["chat"]):
        got = _post(port, "/v1/chat/completions", body)
        assert got["object"] == "chat.completion"
        assert got["choices"][0]["message"] == w["choices"][0]["message"], (kind, body)
        assert got["usage"] == w["usage"]
    models = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/models",
                                               timeout=30).read())
    assert models["data"][0]["id"] == "ray-tpu-llm"
    # the replica's stats keep each answered request's engine timings, in order
    stats = rt.get(serve.get_deployment_handle("OpenAIServer").stats.remote(), timeout=30)
    recent = stats["recent_requests"]
    assert [r["num_generated"] for r in recent] == [
        w["usage"]["completion_tokens"] for w in want["completions"] + want["chat"]]
    assert all(0 < r["ttft_s"] <= r["total_s"] for r in recent), recent


def test_sse_chunks_join_to_the_jax_text(jax_openai):
    kind, tcfg, want, params = jax_openai
    port = _serve_openai(tcfg, params)
    body, w = COMPLETIONS[0], want["completions"][0]
    chunks = _post(port, "/v1/completions", {**body, "stream": True})
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
    assert "".join(c["choices"][0]["text"] for c in chunks) == w["choices"][0]["text"]
    body, w = CHATS[0], want["chat"][0]
    chunks = _post(port, "/v1/chat/completions", {**body, "stream": True})
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert chunks[-1]["choices"][0] == {"index": 0, "delta": {}, "finish_reason": "stop"}
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    assert text == w["choices"][0]["message"]["content"], kind


def test_llm_deployment_gives_the_jax_servers_token_ids():
    jcfg, tcfg = _configs("dense")
    server = _in_process(jllm.build_llm_deployment(jcfg))
    bodies = [{"prompt_ids": [5, 9, 13, 2, 7], "max_tokens": MAX_TOKENS},
              {"prompt_ids": list(range(1, 40)), "max_tokens": MAX_TOKENS}]
    try:
        want = [server(b) for b in bodies]
        params = _torch_params(server.engine, tcfg.model_config)
    finally:
        server.engine.shutdown()
    serve.run(serve.build_llm_deployment(tcfg, params=params, device="cpu"), route_prefix="/llm")
    port = serve.start_http_proxy(port=0).port
    for body, w in zip(bodies, want):
        got = _post(port, "/llm", body)["result"]
        assert got["token_ids"] == w["token_ids"]
        assert got["usage"] == w["usage"] and got["finish_reason"] == w["finish_reason"]
    frames = _post(port, "/llm", {**bodies[0], "stream": True})
    assert frames == want[0]["token_ids"]


@pytest.mark.parametrize("app", ["openai", "llm"])
def test_run_without_a_card_raises_no_cuda_device(monkeypatch, app):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = serve.build_openai_app if app == "openai" else serve.build_llm_deployment
    cfg = PagedLLMConfig() if app == "openai" else LLMConfig()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(build(cfg))
    assert time.monotonic() - t0 < 10
    assert serve.status() == {}
