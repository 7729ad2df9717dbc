"""OpenAI-compatible HTTP serving over the port's generate loop.

Counterpart of unsloth_tpu/inference/server.py in single-flight mode: a
stdlib ``ThreadingHTTPServer`` in front of ``generate``, with one lock so
that one request generates at a time. Routes: ``GET /health``,
``GET /v1/models``, ``POST /v1/chat/completions`` and
``POST /v1/completions`` (with ``stream``: generate, then send the text in
chunks as server-sent events). Request and response shapes are the JAX
server's.

Not ported yet: the `/v1/messages`, responses and embeddings routes, tool
calls, multimodal content, adapters by name, speculative decoding, fp8 KV
caches and the continuous batcher (constructor options that ask for one
raise ``NotImplementedError``; such requests get an error response).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict

from .generate import SamplingParams, generate


class InferenceServer:
    def __init__(self, model, tokenizer=None, model_name: str = "local",
                 continuous_batching: bool = False, speculative: bool = False,
                 adapters: Dict[str, Any] = None,
                 kv_cache_dtype: str = "bf16"):
        for knob, value in (("continuous_batching", continuous_batching),
                            ("speculative", speculative),
                            ("adapters", adapters),
                            ("kv_cache_dtype", kv_cache_dtype != "bf16")):
            if value:
                raise NotImplementedError(
                    f"InferenceServer({knob}=...) is not ported yet")
        self.model = model
        self.tokenizer = tokenizer or model.tokenizer
        self.model_name = model_name
        self._lock = threading.Lock()  # single-flight generation

    def _gen_text(self, prompt: str, params: SamplingParams) -> str:
        with self._lock:
            return generate(self.model, [prompt], params,
                            tokenizer=self.tokenizer)[0]

    def _gen_stream(self, prompt: str, params: SamplingParams):
        """Generate, then yield the text in 16-character chunks (keeps the
        SSE shape for clients that ask for stream=true)."""
        text = self._gen_text(prompt, params)
        for i in range(0, len(text), 16):
            yield text[i:i + 16]

    @staticmethod
    def _stop_list(body) -> list:
        stop = body.get("stop") or body.get("stop_sequences") or []
        return [stop] if isinstance(stop, str) else list(stop)

    @staticmethod
    def _apply_stop(text: str, stops: list) -> str:
        """OpenAI ``stop``: cut at the first occurrence of any stop string
        (the stop itself is not returned)."""
        for s in stops:
            i = text.find(s)
            if i >= 0:
                text = text[:i]
        return text

    @staticmethod
    def _text_messages(messages) -> list:
        for m in messages:
            if not isinstance(m.get("content"), str) or m.get("tool_calls") \
                    or m.get("role") == "tool":
                raise NotImplementedError(
                    "content blocks, images and tool messages are not "
                    "ported yet")
        return messages

    def _chat_prompt_params(self, body):
        if body.get("tools"):
            raise NotImplementedError("tool calling is not ported yet")
        prompt = self._render(self._text_messages(body["messages"]))
        params = SamplingParams(
            max_tokens=int(body.get("max_tokens",
                                    body.get("max_completion_tokens", 256))),
            temperature=float(body.get("temperature", 0.7)),
            top_p=float(body.get("top_p", 1.0)),
            seed=int(body.get("seed", 0)),
        )
        return prompt, params

    @staticmethod
    def _completion_prompt_params(body):
        prompt = body["prompt"]
        if isinstance(prompt, list):
            prompt = prompt[0]
        params = SamplingParams(
            max_tokens=int(body.get("max_tokens", 256)),
            temperature=float(body.get("temperature", 0.7)))
        return prompt, params

    def chat_completion(self, body: Dict[str, Any]) -> Dict[str, Any]:
        prompt, params = self._chat_prompt_params(body)
        text = self._apply_stop(self._gen_text(prompt, params),
                                self._stop_list(body))
        n_prompt = len(self.tokenizer(prompt)["input_ids"])
        n_out = len(self.tokenizer(text)["input_ids"])
        return {
            "id": f"chatcmpl-{uuid.uuid4().hex[:16]}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": body.get("model", self.model_name),
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": "stop",
            }],
            "usage": {"prompt_tokens": n_prompt,
                      "completion_tokens": n_out,
                      "total_tokens": n_prompt + n_out},
        }

    def completions(self, body: Dict[str, Any]) -> Dict[str, Any]:
        prompt, params = self._completion_prompt_params(body)
        text = self._apply_stop(self._gen_text(prompt, params),
                                self._stop_list(body))
        return {
            "id": f"cmpl-{uuid.uuid4().hex[:16]}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": body.get("model", self.model_name),
            "choices": [{"index": 0, "text": text, "finish_reason": "stop"}],
        }

    def models_list(self) -> Dict[str, Any]:
        return {"object": "list",
                "data": [{"id": self.model_name, "object": "model",
                          "owned_by": "unsloth_tpu"}]}

    def _render(self, messages) -> str:
        if getattr(self.tokenizer, "chat_template", None):
            return self.tokenizer.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True)
        text = "\n".join(f"{m['role']}: {m['content']}" for m in messages)
        return text + "\nassistant:"

    # -- HTTP plumbing ---------------------------------------------------

    def make_handler(server):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, code: int, payload: Dict[str, Any]):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _sse_start(self):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()

            def _sse(self, payload):
                data = payload if isinstance(payload, str) \
                    else json.dumps(payload)
                self.wfile.write(f"data: {data}\n\n".encode())
                self.wfile.flush()

            def _stream_chat(self, body):
                prompt, params = server._chat_prompt_params(body)
                base = {"id": f"chatcmpl-{uuid.uuid4().hex[:16]}",
                        "object": "chat.completion.chunk",
                        "created": int(time.time()),
                        "model": body.get("model", server.model_name)}
                self._sse_start()
                self._sse({**base, "choices": [{
                    "index": 0, "delta": {"role": "assistant", "content": ""},
                    "finish_reason": None}]})
                for delta in server._gen_stream(prompt, params):
                    self._sse({**base, "choices": [{
                        "index": 0, "delta": {"content": delta},
                        "finish_reason": None}]})
                self._sse({**base, "choices": [{
                    "index": 0, "delta": {}, "finish_reason": "stop"}]})
                self._sse("[DONE]")

            def _stream_completions(self, body):
                prompt, params = server._completion_prompt_params(body)
                base = {"id": f"cmpl-{uuid.uuid4().hex[:16]}",
                        "object": "text_completion",
                        "created": int(time.time()),
                        "model": body.get("model", server.model_name)}
                self._sse_start()
                for delta in server._gen_stream(prompt, params):
                    self._sse({**base, "choices": [{
                        "index": 0, "text": delta, "finish_reason": None}]})
                self._sse({**base, "choices": [{
                    "index": 0, "text": "", "finish_reason": "stop"}]})
                self._sse("[DONE]")

            def do_GET(self):
                if self.path == "/v1/models":
                    return self._send(200, server.models_list())
                if self.path == "/health":
                    return self._send(200, {"status": "ok"})
                return self._send(404, {"error": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    return self._send(400, {"error": {
                        "message": "invalid JSON body"}})
                try:
                    stream = bool(body.get("stream"))
                    if self.path == "/v1/chat/completions":
                        if stream:
                            return self._stream_chat(body)
                        return self._send(200, server.chat_completion(body))
                    if self.path == "/v1/completions":
                        if stream:
                            return self._stream_completions(body)
                        return self._send(200, server.completions(body))
                    return self._send(404, {"error": "not found"})
                except KeyError as e:
                    return self._send(400, {"error": {
                        "message": f"missing field: {e}"}})
                except Exception as e:  # noqa: BLE001 — report, keep serving
                    return self._send(500, {"error": {
                        "message": f"{type(e).__name__}: {e}"}})

        return Handler

    def serve(self, host: str = "127.0.0.1", port: int = 8000,
              background: bool = False):
        """Serve on (host, port); port 0 picks a free one. With
        ``background`` the server runs in a daemon thread and the
        ``ThreadingHTTPServer`` is returned (``server_address`` holds the
        bound port; ``shutdown()`` stops it)."""
        httpd = ThreadingHTTPServer((host, port), self.make_handler())
        if background:
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            return httpd
        httpd.serve_forever()
