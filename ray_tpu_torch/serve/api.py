"""serve's public calls and its HTTP ingress (the in-process part of
ray_tpu/serve/api.py): ``run``, ``get_deployment_handle``, ``delete``,
``status``, ``shutdown`` and ``start_http_proxy``.

The ingress is the standard library's ``http.server.ThreadingHTTPServer``
(one daemon thread per connection), with the reference's behavior: a JSON
POST to a route goes to ``handle.remote(body)`` and its answer comes back as
``{"result": ...}``; ``{"stream": true}`` gives ``text/event-stream`` frames
ending in ``data: [DONE]``, a stream's error a ``data: {"error": ...}``
frame; under a deployment that ``build_openai_app`` made, the OpenAI
subpaths select its methods and the answer is the OpenAI object itself. 404
for no route, 400 for a body that is not JSON, 500 for a failed request;
requests time out after 60 s (120 s on the OpenAI subpaths).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import ray_tpu_torch
from ray_tpu_torch.core.runtime import get_runtime
from ray_tpu_torch.exceptions import TaskError
from ray_tpu_torch.serve.controller import (CONTROLLER_NAME, REPLICA_START_TIMEOUT_S,
                                            DeploymentHandle, ServeController)
from ray_tpu_torch.serve.deployment import Application
from ray_tpu_torch.serve.openai_api import OPENAI_DEPLOYMENT_NAMES

_state: dict = {"controller": None, "proxy": None, "routes": {}, "runtime": None}
_lock = threading.Lock()

# OpenAI surface: subpath under a route -> (method, streaming method)
_OPENAI_METHODS = {
    "completions": ("completions", "completions_stream"),
    "chat/completions": ("chat_completions", "chat_completions_stream"),
    "models": ("models", None),
}
_TIMEOUT_S, _OPENAI_TIMEOUT_S = 60.0, 120.0


def _get_or_create_controller():
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(ignore_reinit_error=True)
    rt = get_runtime()
    with _lock:
        if _state["runtime"] is not rt:
            # a new runtime: the cached handles point into the old one, so
            # stop the old proxy and release its port
            if _state["proxy"] is not None:
                _state["proxy"].stop()
            _state.update(controller=None, proxy=None, routes={}, runtime=rt)
        if _state["controller"] is None:
            _state["controller"] = ray_tpu_torch.remote(
                num_cpus=0, max_concurrency=16)(ServeController).options(
                name=CONTROLLER_NAME, get_if_exists=True).remote()
        return _state["controller"]


def run(app: Application, *, route_prefix: str | None = "/") -> DeploymentHandle:
    """Deploy an application and return its handle once its replicas are
    constructed; a replica constructor's error is raised here."""
    controller = _get_or_create_controller()
    dep = app.deployment
    prefix = dep.config.route_prefix or route_prefix
    if prefix:
        bound = ray_tpu_torch.get(controller.get_routes.remote(), timeout=30).get(prefix)
        if bound is not None and bound != dep.config.name:
            raise ValueError(f"Route prefix {prefix!r} is already bound to deployment "
                             f"'{bound}'; pass a distinct route_prefix.")
    try:
        ray_tpu_torch.get(controller.deploy.remote(dep, prefix),
                          timeout=REPLICA_START_TIMEOUT_S + 30)
    except TaskError as e:  # the controller's (or a replica constructor's) own error
        raise e.cause
    handle = DeploymentHandle(controller, dep.config.name)
    if prefix:
        with _lock:
            _state["routes"] = {**_state["routes"], prefix: handle}
    return handle


def get_deployment_handle(name: str) -> DeploymentHandle:
    controller = _get_or_create_controller()
    if name not in ray_tpu_torch.get(controller.get_deployment_names.remote(), timeout=30):
        raise ValueError(f"Deployment {name!r} not found")
    return DeploymentHandle(controller, name)


def delete(name: str) -> None:
    controller = _get_or_create_controller()
    ray_tpu_torch.get(controller.delete_deployment.remote(name), timeout=30)
    with _lock:
        _state["routes"] = {p: h for p, h in _state["routes"].items()
                            if h.deployment_name != name}


def status() -> dict:
    controller = _get_or_create_controller()
    return ray_tpu_torch.get(controller.status.remote(), timeout=30)


def shutdown() -> None:
    """Stop the proxy (its port is free again when this returns), delete
    every deployment and stop the controller."""
    with _lock:
        proxy, controller = _state["proxy"], _state["controller"]
        _state.update(controller=None, proxy=None, routes={})
    if proxy is not None:
        proxy.stop()
    if controller is not None and ray_tpu_torch.is_initialized():
        try:
            ray_tpu_torch.get(controller.shutdown.remote(), timeout=30)
        finally:
            ray_tpu_torch.kill(controller)


def _match_route(path: str, routes: dict | None = None):
    """Longest-prefix route match: (prefix, handle) or (None, None)."""
    best = None
    # snapshot: run()/delete() rebind the dict rather than mutating it
    for prefix, handle in list((_state["routes"] if routes is None else routes).items()):
        if path == prefix or path.startswith(prefix.rstrip("/") + "/") or prefix == "/":
            if best is None or len(prefix) > len(best[0]):
                best = (prefix, handle)
    return best if best else (None, None)


def _json_safe(result):
    return result if isinstance(result, (dict, list, str, int, float)) or result is None \
        else repr(result)


class HttpProxy:
    """The HTTP ingress. ``port=0`` takes a free port from the OS; ``port``
    then reads back the one bound."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                proxy._handle(self)

            do_GET = do_POST

            def log_message(self, format, *args):  # noqa: A002 - the base's name
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host, self.port = host, self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        kwargs={"poll_interval": 0.1}, daemon=True,
                                        name=f"serve-http-{self.port}")
        self._thread.start()

    @staticmethod
    def _reply(req: BaseHTTPRequestHandler, status: int, obj) -> None:
        data = json.dumps(obj).encode()
        req.send_response(status)
        req.send_header("Content-Type", "application/json")
        req.send_header("Content-Length", str(len(data)))
        req.end_headers()
        req.wfile.write(data)

    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        path = req.path.split("?", 1)[0]
        route, handle = _match_route(path)
        if handle is None:
            return self._reply(req, 404, {"error": f"no route for {path}"})
        try:
            length = int(req.headers.get("Content-Length") or 0)
            raw = req.rfile.read(length) if length > 0 else b""
            body = json.loads(raw) if raw else {}
        except ValueError:  # a bad length, bytes that are not UTF-8, or not JSON
            return self._reply(req, 400, {"error": "invalid JSON body"})
        sub = path[len(route.rstrip("/")):].strip("/")
        if sub in _OPENAI_METHODS and handle.deployment_name in OPENAI_DEPLOYMENT_NAMES:
            method, stream_method = _OPENAI_METHODS[sub]
            if isinstance(body, dict) and body.get("stream") and stream_method:
                return self._stream(req, handle, {**body, "stream_method": stream_method})
            try:
                result = ray_tpu_torch.get(getattr(handle, method).remote(body),
                                           timeout=_OPENAI_TIMEOUT_S)
            except Exception as e:  # noqa: BLE001 - the client gets the error
                return self._reply(req, 500, {"error": {"message": str(e)[:500],
                                                        "type": type(e).__name__}})
            return self._reply(req, 200, result)
        if isinstance(body, dict) and body.get("stream"):
            return self._stream(req, handle, body)
        try:
            result = ray_tpu_torch.get(handle.remote(body), timeout=_TIMEOUT_S)
        except Exception as e:  # noqa: BLE001 - the client gets the error
            return self._reply(req, 500, {"error": str(e)[:500]})
        return self._reply(req, 200, {"result": _json_safe(result)})

    @staticmethod
    def _stream(req: BaseHTTPRequestHandler, handle, body: dict) -> None:
        """Server-sent events: one ``data:`` frame per yielded item."""
        req.send_response(200)
        req.send_header("Content-Type", "text/event-stream")
        req.send_header("Cache-Control", "no-cache")
        req.end_headers()
        it = handle.stream(body, method_name=body.get("stream_method", "stream_tokens"))
        try:
            while True:
                try:
                    item = next(it)
                except StopIteration:
                    break
                except Exception as e:  # noqa: BLE001 - a stream error becomes a frame
                    err = str(e).splitlines()[-1][:200] if str(e) else type(e).__name__
                    req.wfile.write(f"data: {json.dumps({'error': err})}\n\n".encode())
                    break
                req.wfile.write(f"data: {json.dumps(item)}\n\n".encode())
            req.wfile.write(b"data: [DONE]\n\n")
        except ConnectionError:
            pass  # the client went away; the replica finishes on its own
        finally:
            it.close()  # releases the router's in-flight slot

    def stop(self) -> None:
        """Stop serving and close the listening socket."""
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)


def start_http_proxy(host: str = "127.0.0.1", port: int = 8000) -> HttpProxy:
    _get_or_create_controller()  # binds the proxy to this runtime
    with _lock:
        if _state["proxy"] is None:
            _state["proxy"] = HttpProxy(host, port)
        return _state["proxy"]
