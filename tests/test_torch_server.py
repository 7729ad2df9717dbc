"""The PyTorch port's InferenceServer: greedy chat_completion and
completions return the same text as the JAX package's server on the same
weights, and an HTTP round trip answers 200 on all four routes."""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unsloth_tpu.inference.server import InferenceServer as JServer
from unsloth_tpu.models.config import ModelConfig as JConfig
from unsloth_tpu.models.loader import LanguageModel as JModel
from unsloth_tpu.models.params import init_params
from unsloth_tpu_torch.inference.server import InferenceServer as TServer
from unsloth_tpu_torch.interop import params_from_numpy
from unsloth_tpu_torch.models.config import ModelConfig as TConfig
from unsloth_tpu_torch.models.loader import LanguageModel as TModel

CFG = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
           num_layers=2, num_heads=2, num_kv_heads=2,
           max_position_embeddings=256, eos_token_id=0)
CHAT = {"messages": [{"role": "system", "content": "Be brief."},
                     {"role": "user", "content": "Hi there"}],
        "max_tokens": 8, "temperature": 0.0}
COMPLETION = {"prompt": "Once upon", "max_tokens": 8, "temperature": 0.0}


class CharTokenizer:
    """Minimal tokenizer: one char = one token (ascii)."""

    eos_token_id = 0
    pad_token_id = 0

    def __call__(self, text, **kw):
        return {"input_ids": [ord(c) % 128 for c in text]}

    def decode(self, ids, **kw):
        return "".join(chr(i) for i in ids if i > 0)


@pytest.fixture(scope="module")
def servers():
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    jp = init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32,
                     init_scale=0.2)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tok = CharTokenizer()
    return (JServer(JModel(cfg=jcfg, params=jp), tokenizer=tok),
            TServer(TModel(cfg=tcfg, params=tp), tokenizer=tok))


def test_chat_and_completions_match_jax(servers):
    js, ts = servers
    jc, tc = js.chat_completion(dict(CHAT)), ts.chat_completion(dict(CHAT))
    assert tc["choices"][0]["message"] == jc["choices"][0]["message"]
    assert tc["usage"] == jc["usage"]
    assert tc["object"] == "chat.completion"
    jt, tt = js.completions(dict(COMPLETION)), ts.completions(dict(COMPLETION))
    assert tt["choices"][0]["text"] == jt["choices"][0]["text"]
    assert {k for k in tt} == {k for k in jt}


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 method="GET" if body is None else "POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        raw = r.read()
        return r.status, r.headers.get("Content-Type"), raw


def test_http_round_trip(servers):
    _, ts = servers
    httpd = ts.serve("127.0.0.1", 0, background=True)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert _call(base + "/health")[0] == 200
        status, _, raw = _call(base + "/v1/models")
        assert status == 200 and json.loads(raw)["data"][0]["id"] == "local"
        status, _, raw = _call(base + "/v1/chat/completions", CHAT)
        assert status == 200
        assert json.loads(raw)["choices"][0]["message"]["content"] == \
            ts.chat_completion(dict(CHAT))["choices"][0]["message"]["content"]
        status, _, raw = _call(base + "/v1/completions", COMPLETION)
        assert status == 200 and json.loads(raw)["object"] == "text_completion"
        status, ctype, raw = _call(base + "/v1/completions",
                                   dict(COMPLETION, stream=True))
        assert status == 200 and ctype == "text/event-stream"
        assert raw.decode().rstrip().endswith("data: [DONE]")
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_unported_server_options_raise(servers):
    _, ts = servers
    with pytest.raises(NotImplementedError):
        TServer(ts.model, tokenizer=ts.tokenizer, continuous_batching=True)
    with pytest.raises(NotImplementedError):
        ts.chat_completion(dict(CHAT, tools=[{"type": "function"}]))
