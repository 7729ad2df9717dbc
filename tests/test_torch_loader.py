"""Checkpoint loading of the PyTorch port: from_pretrained gives the same
trees as the JAX package's (NF4 bytes equal), its own safetensors reader
and writer interoperate with the safetensors package, and ModelConfig
parses HF configs field for field as the JAX package's does."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import load_file as st_load
from safetensors.torch import save_file as st_save

from helpers import TINY_LLAMA, TINY_QWEN3, make_hf_checkpoint
from unsloth_tpu.models.config import ModelConfig as JConfig
from unsloth_tpu.models.loader import FastLanguageModel as JFast
from unsloth_tpu_torch import io_safetensors as sio
from unsloth_tpu_torch.interop import to_tensor
from unsloth_tpu_torch.models.config import ModelConfig as TConfig
from unsloth_tpu_torch.models.loader import FastLanguageModel as TFast
from unsloth_tpu_torch.ops.nf4 import NF4Tensor

HF = dict(TINY_LLAMA, vocab_size=256, hidden_size=128, intermediate_size=256,
          rope_scaling={"rope_type": "llama3", "factor": 8.0,
                        "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                        "original_max_position_embeddings": 32})


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny_llama"))
    make_hf_checkpoint(path, HF)
    return path


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("load_in_4bit", [False, True])
def test_from_pretrained_trees_match_jax(ckpt, load_in_4bit):
    jm, _ = JFast.from_pretrained(ckpt, load_in_4bit=load_in_4bit,
                                  dtype="float32")
    tm, _ = TFast.from_pretrained(ckpt, load_in_4bit=load_in_4bit,
                                  dtype="float32", device="cpu")
    jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, jm.params)))
    tl = dict(_leaves(tm.params))
    assert jl.keys() == tl.keys()
    n_nf4 = 0
    for name, t in tl.items():
        j = jl[name]
        if isinstance(t, NF4Tensor):
            n_nf4 += 1
            np.testing.assert_array_equal(t.packed.numpy(),
                                          np.asarray(j.packed))
            assert np.abs(t.absmax.numpy().astype(int)
                          - np.asarray(j.absmax).astype(int)).max() <= 1
            np.testing.assert_allclose(t.absmax_scale.numpy(),
                                       np.asarray(j.absmax_scale), rtol=1e-5)
            assert t.shape == tuple(j.shape)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert n_nf4 == (7 * HF["num_hidden_layers"] if load_in_4bit else 0)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)


@pytest.mark.parametrize("hf", [TINY_LLAMA, TINY_QWEN3, HF, {
    "model_type": "llama", "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "vocab_size": 128256, "rope_theta": 500000.0,
    "eos_token_id": [128001, 128008, 128009],
    "rope_scaling": HF["rope_scaling"]}])
def test_model_config_matches_jax(hf):
    assert dataclasses.asdict(TConfig.from_hf_config(hf)) == \
        dataclasses.asdict(JConfig.from_hf_config(hf))


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "w.bf16": torch.randn((6, 8), generator=g).to(torch.bfloat16),
        "w.f32": torch.randn((3, 5, 2), generator=g),
        "codes.i8": torch.randint(-127, 128, (9,), generator=g,
                                  dtype=torch.int8),
        "bytes.u8": torch.randint(0, 256, (4, 4), generator=g,
                                  dtype=torch.uint8),
        "scalar": torch.tensor(1.5),
        "empty": torch.zeros((0, 3)),
    }


def test_reader_reads_safetensors_package_files(tmp_path):
    ref = _tensors()
    path = str(tmp_path / "a.safetensors")
    st_save(ref, path, metadata={"format": "pt"})
    f = sio.SafetensorsFile(path)
    assert f.metadata == {"format": "pt"}
    assert set(f.keys()) == set(ref)
    for k, t in ref.items():
        assert f.get(k).dtype == t.dtype and torch.equal(f.get(k), t)


def test_safetensors_package_reads_writer_output(tmp_path):
    ref = _tensors()
    path = str(tmp_path / "b.safetensors")
    sio.save_file(ref, path, metadata={"format": "pt"})
    got = st_load(path)
    for k, t in ref.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t)


def test_sharded_writer_round_trip(tmp_path):
    ref = _tensors()
    entries = [(k, t.dtype, tuple(t.shape)) for k, t in ref.items()]
    names = sio.save_sharded(str(tmp_path), entries, ref.__getitem__,
                             max_shard_bytes=100)
    assert len(names) > 1
    with open(tmp_path / "model.safetensors.index.json") as fh:
        index = json.load(fh)
    assert set(index["weight_map"]) == set(ref)
    for k, t in ref.items():
        shard = st_load(str(tmp_path / index["weight_map"][k]))
        assert torch.equal(shard[k], t)
    with pytest.raises(ValueError):
        with sio.SafetensorsWriter(str(tmp_path / "c.safetensors"),
                                   entries) as w:
            w.write("w.f32", ref["w.f32"])      # out of order


def test_loader_reads_sharded_bf16_checkpoint(tmp_path, ckpt):
    """An index-sharded bf16 copy written by the port loads to the same
    tree as the safetensors package's single-file original cast to bf16."""
    src = st_load(os.path.join(ckpt, "model.safetensors"))
    entries = [(k, torch.bfloat16, tuple(t.shape)) for k, t in src.items()]
    sio.save_sharded(str(tmp_path), entries,
                     lambda k: src[k].to(torch.bfloat16), max_shard_bytes=1 << 17)
    with open(os.path.join(ckpt, "config.json")) as fh, \
            open(tmp_path / "config.json", "w") as out:
        out.write(fh.read())
    a, _ = TFast.from_pretrained(ckpt, load_in_4bit=True, device="cpu")
    b, _ = TFast.from_pretrained(str(tmp_path), load_in_4bit=True,
                                 device="cpu")
    for (na, ta), (nb, tb) in zip(_leaves(a.params), _leaves(b.params)):
        assert na == nb
        if isinstance(ta, NF4Tensor):
            assert torch.equal(ta.packed, tb.packed)
        else:
            assert torch.equal(ta, tb)


def test_to_tensor_carries_bfloat16_bits():
    import jax.numpy as jnp

    x = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = to_tensor(x, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))
