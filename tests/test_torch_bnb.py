"""Pre-quantized bitsandbytes 4-bit checkpoints in the PyTorch port against
the JAX package, on the CPU: the same bnb tensor sets (written by the JAX
package's test oracle, tests/test_bnb_interop.py) decoded by both packages
into NF4 weights equal byte for byte, absmax equal, dequantized weights
bit-equal to each other and to the oracle's double dequantization; fp4 and
a foreign codebook refused; a whole bnb-4bit checkpoint loaded by both
packages (no quantization on load, whatever ``load_in_4bit`` says) giving
the same logits; and the bnb writer of chip_smoke.py read back by both."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.helpers import TINY_LLAMA
from tests.test_bnb_interop import (_make_bnb_checkpoint, bnb_quantize_4bit,
                                    oracle_dequant)
from unsloth_tpu.models import bnb as jbnb
from unsloth_tpu.models import decoder as jdec
from unsloth_tpu.models import hf_loader as jloader
from unsloth_tpu.models.config import ModelConfig as JConfig
from unsloth_tpu.ops.nf4 import dequantize_nf4 as jdequantize
from unsloth_tpu_torch import FastLanguageModel
from unsloth_tpu_torch.models import bnb as tbnb
from unsloth_tpu_torch.models import decoder as tdec
from unsloth_tpu_torch.models import hf_loader as tloader
from unsloth_tpu_torch.ops.nf4 import NF4Tensor
from unsloth_tpu_torch.ops.nf4 import dequantize_nf4 as tdequantize

PROJ = ("q", "k", "v", "o", "gate", "up", "down")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _both(tensors, state, nested=True):
    """The same bnb tensor set decoded by the JAX package and the port
    (fp32 dequant target)."""
    absmax = tensors["absmax"]
    extra = dict(quant_map=tensors["quant_map"])
    if nested:
        extra.update(nested_absmax=tensors["nested_absmax"],
                     nested_quant_map=tensors["nested_quant_map"])
    else:
        absmax = jbnb.decode_absmax(
            absmax, tensors["nested_absmax"], tensors["nested_quant_map"],
            state["nested_blocksize"], state["nested_offset"])
    jq = jbnb.bnb_to_nf4(tensors["weight"], state, absmax,
                         dtype=jnp.float32, **extra)
    tq = tbnb.bnb_to_nf4(_t(tensors["weight"]), state, _t(absmax),
                         dtype=torch.float32,
                         **{k: _t(v) for k, v in extra.items()})
    return jq, tq


@pytest.mark.parametrize("shape,seed", [((16, 256), 1), ((96, 640), 4),
                                        ((130, 64), 5)])
def test_bnb_decode_matches_jax_bit_for_bit(shape, seed):
    """Double-quantized absmax (groups of 256 scales, the last one short at
    130 x 64): packed bytes equal byte for byte, the decoded fp32 absmax
    equal, no double quantization kept (absmax_scale None), and the
    dequantized weights bit-equal in both packages and to the oracle."""
    w = (np.random.RandomState(seed).randn(*shape) * 0.05).astype(np.float32)
    tensors, state = bnb_quantize_4bit(w)
    jq, tq = _both(tensors, state)
    assert tq.absmax_scale is None and tq.absmax_offset is None
    assert tq.absmax.dtype == torch.float32 and tq.shape == shape
    np.testing.assert_array_equal(tq.packed.numpy(), np.asarray(jq.packed))
    np.testing.assert_array_equal(tq.absmax.numpy().view(np.uint32),
                                  np.asarray(jq.absmax).view(np.uint32))
    got = tdequantize(tq, torch.float32).numpy()
    np.testing.assert_array_equal(
        got.view(np.uint32),
        np.asarray(jdequantize(jq, jnp.float32)).view(np.uint32))
    np.testing.assert_array_equal(got, oracle_dequant(tensors, state))


def test_decode_absmax_keeps_the_fp32_order():
    """decode_absmax rounds the product, then the sum (bnb's order), as the
    JAX package does: bit-equal, and different from a fused multiply-add
    somewhere on this data."""
    w = (np.random.RandomState(6).randn(64, 1024) * 0.05).astype(np.float32)
    tensors, state = bnb_quantize_4bit(w)
    args = (tensors["nested_absmax"], tensors["nested_quant_map"],
            state["nested_blocksize"], state["nested_offset"])
    want = jbnb.decode_absmax(tensors["absmax"], *args)
    got = tbnb.decode_absmax(_t(tensors["absmax"]),
                             *(_t(a) for a in args[:2]), *args[2:])
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    fused = (np.float64(tensors["nested_quant_map"][tensors["absmax"]])
             * np.repeat(tensors["nested_absmax"], 256)[:want.size]
             + np.float64(np.float32(state["nested_offset"]))
             ).astype(np.float32)
    assert not np.array_equal(fused, want)


def test_plain_fp32_absmax_accepted():
    """A bnb set whose absmax is stored as fp32 (no double quantization):
    the same NF4 weight as the double-quantized set decodes to."""
    w = (np.random.RandomState(2).randn(8, 128) * 0.1).astype(np.float32)
    tensors, state = bnb_quantize_4bit(w)
    jq, tq = _both(tensors, state, nested=False)
    np.testing.assert_array_equal(tq.absmax.numpy(), np.asarray(jq.absmax))
    np.testing.assert_array_equal(tdequantize(tq, torch.float32).numpy(),
                                  oracle_dequant(tensors, state))


def test_fp4_and_foreign_codebook_refused():
    w = (np.random.RandomState(3).randn(8, 128) * 0.1).astype(np.float32)
    tensors, state = bnb_quantize_4bit(w)
    with pytest.raises(NotImplementedError, match="fp4"):
        tbnb.bnb_to_nf4(_t(tensors["weight"]), dict(state, quant_type="fp4"),
                        _t(tensors["absmax"]))
    with pytest.raises(ValueError, match="NF4 codebook"):
        tbnb.bnb_to_nf4(_t(tensors["weight"]), state, _t(tensors["absmax"]),
                        quant_map=_t(tensors["quant_map"] * 0.5))


def test_repack_matches_jax():
    idx = np.random.RandomState(0).randint(0, 16, (8, 128)).astype(np.uint8)
    flat = idx.reshape(-1)
    interleaved = ((flat[0::2] << 4) | flat[1::2]).reshape(-1, 1)
    got = tbnb.repack_interleaved_to_split_half(_t(interleaved), (8, 128))
    np.testing.assert_array_equal(
        got.numpy(), jbnb.repack_interleaved_to_split_half(interleaved,
                                                           (8, 128)))
    assert (got.numpy() >> 4 == idx[:, :64]).all()
    assert (got.numpy() & 0xF == idx[:, 64:]).all()


def test_parse_quant_state_matches_jax():
    blob = np.frombuffer(json.dumps({"quant_type": "nf4", "blocksize": 64,
                                     "shape": [4, 128]}).encode(),
                         np.uint8).copy()
    assert tbnb.parse_quant_state(_t(blob)) == jbnb.parse_quant_state(blob)


# ---------------------------------------------------------------------------
# a whole bnb-4bit checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bnb_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bnb4"))
    dense = _make_bnb_checkpoint(path, TINY_LLAMA)
    return path, dense


@pytest.fixture(scope="module")
def jax_tree(bnb_dir):
    path, _ = bnb_dir
    jcfg = JConfig.from_hf_config(TINY_LLAMA)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UNSLOTH_VALIDATE_CHECKPOINT", "0")
        params = jloader.load_params(path, jcfg, dtype=jnp.float32,
                                     load_in_4bit=True)
    return jcfg, params


@pytest.mark.parametrize("load_in_4bit", [True, False])
def test_bnb_checkpoint_loads_as_in_jax(bnb_dir, jax_tree, monkeypatch,
                                        load_in_4bit):
    """from_pretrained on the bnb-4bit directory: every projection is an NF4
    weight, without a call of quantize_nf4 (load_in_4bit either way),
    equal byte for byte to the JAX package's and bit-equal in its dequant
    to the oracle's; the logits equal JAX's (f32, rtol 1e-5)."""
    path, dense = bnb_dir
    jcfg, jparams = jax_tree

    def no_quantize(*a, **kw):
        raise AssertionError("quantize_nf4 ran on a bnb checkpoint")

    monkeypatch.setattr(tloader, "quantize_nf4", no_quantize)
    model, _ = FastLanguageModel.from_pretrained(
        path, load_in_4bit=load_in_4bit, dtype=torch.float32, device="cpu")
    for i, (tl, jl) in enumerate(zip(model.params["layers"],
                                     jparams["layers"])):
        for name in PROJ:
            assert isinstance(tl[name], NF4Tensor), name
            assert tl[name].absmax_scale is None
            np.testing.assert_array_equal(tl[name].packed.numpy(),
                                          np.asarray(jl[name].packed))
            np.testing.assert_array_equal(tl[name].absmax.numpy(),
                                          np.asarray(jl[name].absmax))
        np.testing.assert_array_equal(
            tdequantize(tl["down"], torch.float32).numpy(),
            dense[f"model.layers.{i}.mlp.down_proj"])
    ids = np.random.default_rng(0).integers(0, TINY_LLAMA["vocab_size"],
                                            (2, 24))
    want = np.asarray(jdec.logits_fn(jparams, None, jnp.asarray(ids), jcfg))
    got = tdec.logits_fn(model.params, None, _t(ids), model.cfg, remat=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_chip_smoke_bnb_writer_reads_back(tmp_path, monkeypatch):
    """chip_smoke's bnb-4bit writer (a tiny Llama-3.2-shaped config: head
    dim 64, tied embedding, llama3 rope): the JAX package's loader reads
    what it writes; both packages decode equal NF4 weights; the dequantized
    projections sit within one NF4 step of the random weights they came
    from; the companion tensors have bnb's names, dtypes and shapes."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setenv("UNSLOTH_VALIDATE_CHECKPOINT", "0")
    hf = dict(chip_smoke.LLAMA_32_1B_CONFIG, hidden_size=128,
              intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, vocab_size=300)
    chip_smoke.write_checkpoint(str(tmp_path), hf, bnb4=True)
    reader = tloader.CheckpointReader(str(tmp_path))
    name = "model.layers.1.mlp.down_proj.weight"
    assert tbnb.is_bnb_quantized(reader, name)
    assert reader.get(name).dtype == torch.uint8
    assert tuple(reader.get(name).shape) == (128 * 256 // 2, 1)
    assert reader.get(name + ".absmax").dtype == torch.uint8
    assert tuple(reader.get(name + ".nested_quant_map").shape) == (256,)
    assert "lm_head.weight" not in reader
    assert reader.get("model.embed_tokens.weight").dtype == torch.bfloat16
    model, _ = FastLanguageModel.from_pretrained(
        str(tmp_path), dtype=torch.float32, device="cpu")
    jcfg = JConfig.from_hf_config(hf)
    jparams = jloader.load_params(str(tmp_path), jcfg, dtype=jnp.float32)
    for tl, jl in zip(model.params["layers"], jparams["layers"]):
        for proj in PROJ:
            np.testing.assert_array_equal(tl[proj].packed.numpy(),
                                          np.asarray(jl[proj].packed))
            np.testing.assert_array_equal(
                tdequantize(tl[proj], torch.float32).numpy(),
                np.asarray(jdequantize(jl[proj], jnp.float32)))
    dense = chip_smoke.checkpoint_tensor(hf, name).float()
    deq = tdequantize(model.params["layers"][1]["down"], torch.float32)
    blocks = dense.reshape(-1, 64).abs().amax(-1, keepdim=True)
    err = (deq - dense).reshape(-1, 64).abs() / blocks
    # half the widest gap of the NF4 codebook, plus the absmax's 8-bit code
    assert err.max() <= 0.2
    ids = np.random.default_rng(1).integers(0, 300, (1, 16))
    want = np.asarray(jdec.logits_fn(jparams, None, jnp.asarray(ids), jcfg))
    got = tdec.logits_fn(model.params, None, _t(ids), model.cfg, remat=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
