"""The port's import surface against the JAX package's: a notebook ported
by swapping ``unsloth_tpu`` for ``unsloth_tpu_torch`` finds every name
whose module the port has, with the JAX package's meaning, at the same
path (the root, ``trainer``, ``models``, ``inference``, ``ops``); a name
whose module is not ported raises AttributeError naming that module. On
a tiny llama loaded by both packages, ``LanguageModel.loss_fn`` /
``forward`` / ``logits`` are the port's decoder functions and match the
JAX package's ``model.loss_fn``; ``count_params`` matches JAX's."""

import importlib
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unsloth_tpu
import unsloth_tpu_torch
from tests.helpers import TINY_LLAMA, make_hf_checkpoint
from tests.test_torch_unpacked import _nonzero_lora
from unsloth_tpu.models import hf_loader as jloader
from unsloth_tpu.models import params as jparams_mod
from unsloth_tpu.models.config import ModelConfig as JConfig
from unsloth_tpu.models.loader import LanguageModel as JModel
from unsloth_tpu_torch.data.packing import pad_batch
from unsloth_tpu_torch.interop import lora_from_numpy
from unsloth_tpu_torch.models import decoder as tdec
from unsloth_tpu_torch.models import params as tparams_mod

#: the JAX root's names that its module ``__getattr__`` imports on first
#: use, by module (every other root name is an attribute or in ``_LAZY``)
JAX_GETATTR = {"FastVisionModel": "unsloth_tpu.models.vision",
               "FastSentenceTransformer":
                   "unsloth_tpu.models.sentence_transformer",
               "FastDiffusionModel": "unsloth_tpu.models.diffusion"}
SUBPACKAGES = ("trainer", "models", "inference", "ops")


def _port_module(module: str) -> str:
    return "unsloth_tpu_torch" + module[len("unsloth_tpu"):]


def _ported(module: str) -> bool:
    try:
        return importlib.util.find_spec(_port_module(module)) is not None
    except ModuleNotFoundError:   # its parent package is not ported either
        return False


def _root_names():
    """{name: module of the JAX package that defines it} of every public
    root name: its attributes (submodules aside), ``_LAZY`` and the names
    its ``__getattr__`` loads."""
    names = {}
    for name in dir(unsloth_tpu):
        obj = getattr(unsloth_tpu, name)
        if name.startswith("_") or type(obj).__name__ == "module":
            continue
        names[name] = getattr(obj, "__module__", "unsloth_tpu")
    names.update({n: mod for n, (mod, _) in unsloth_tpu._LAZY.items()})
    names.update(JAX_GETATTR)
    names["__version__"] = "unsloth_tpu"
    assert set(unsloth_tpu.__all__) <= set(names)
    return names


def _same_meaning(got, want, module):
    """The port's object for a JAX object: the same class or function name
    (an alias names what it aliases) from the port's counterpart of its
    module."""
    if isinstance(want, str):
        assert isinstance(got, str)
        return
    assert got.__name__ == want.__name__
    assert got.__module__ == _port_module(module)


def test_root_names():
    names = _root_names()
    ported = {n: m for n, m in names.items() if _ported(m)}
    assert {"is_bfloat16_supported", "is_vLLM_available", "FastModel",
            "FastTextModel", "FastQwen3MoeModel", "ModelConfig",
            "RopeScaling", "UnslothTrainer", "UnslothTrainingArguments",
            "vLLMSamplingParams", "SFTTrainer"} <= set(ported)
    for name, module in ported.items():
        got = getattr(unsloth_tpu_torch, name)
        if name in JAX_GETATTR:
            assert got.__name__ == name
            continue
        want = (getattr(importlib.import_module(module),
                        unsloth_tpu._LAZY[name][1])
                if name in unsloth_tpu._LAZY else getattr(unsloth_tpu, name))
        _same_meaning(got, want, module)
    assert unsloth_tpu_torch.FastTextModel is \
        unsloth_tpu_torch.FastLanguageModel
    assert unsloth_tpu_torch.is_vLLM_available() is True
    assert unsloth_tpu_torch.is_bfloat16_supported() is (
        torch.cuda.is_available()
        and torch.cuda.get_device_capability()[0] >= 8)
    for name, module in names.items():
        if name not in ported:
            with pytest.raises(AttributeError, match=module):
                getattr(unsloth_tpu_torch, name)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_names(sub):
    jsub = importlib.import_module(f"unsloth_tpu.{sub}")
    tsub = importlib.import_module(f"unsloth_tpu_torch.{sub}")
    missing = []
    for name in jsub.__all__:
        want = getattr(jsub, name)
        module = want.__module__
        if _ported(module):
            _same_meaning(getattr(tsub, name), want, module)
        else:
            missing.append(name)
            with pytest.raises(AttributeError, match=module):
                getattr(tsub, name)
    # only the trainers the port has not ported are left out
    assert not missing or sub == "trainer"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(JAX model, port model, numpy LoRA tree, padded batch) of one tiny
    llama checkpoint loaded by both packages in f32, the same nonzero LoRA
    tree on both."""
    path = str(tmp_path_factory.mktemp("tiny_llama"))
    make_hf_checkpoint(path, TINY_LLAMA)
    jcfg = JConfig.from_hf_config(TINY_LLAMA)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UNSLOTH_VALIDATE_CHECKPOINT", "0")
        jp = jloader.load_params(path, jcfg, dtype=jnp.float32,
                                 load_in_4bit=False)
    lora_np = jax.tree_util.tree_map(np.asarray, _nonzero_lora(jcfg))
    jm = JModel(cfg=jcfg, params=jp,
                lora=jax.tree_util.tree_map(jnp.asarray, lora_np))
    tm, _ = unsloth_tpu_torch.FastLanguageModel.from_pretrained(
        path, load_in_4bit=False, dtype=torch.float32, device="cpu")
    tm.lora = lora_from_numpy(lora_np, "cpu")
    rng = np.random.default_rng(5)
    batch = pad_batch([{"input_ids": rng.integers(0, 128, n).tolist()}
                       for n in (20, 32)], 32).as_dict()
    return jm, tm, lora_np, batch


def test_language_model_methods(tiny):
    """``model.loss_fn(model.lora, batch)``, ``model.forward`` and
    ``model.logits`` are the port's decoder functions, bit for bit, and
    the loss is JAX's ``model.loss_fn`` within 1e-5 relative (f32)."""
    jm, tm, _, batch = tiny
    tbatch = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in batch.items()}
    ids = tbatch["input_ids"]
    with torch.no_grad():
        loss = tm.loss_fn(tm.lora, tbatch)
        assert torch.equal(loss, tdec.loss_fn(tm.params, tm.lora, tbatch,
                                              tm.cfg))
        assert torch.equal(tm.forward(ids, remat=False), tdec.forward(
            tm.params, tm.lora, ids, tm.cfg, remat=False))
        assert torch.equal(tm.logits(ids), tdec.logits_fn(
            tm.params, tm.lora, ids, tm.cfg))
    want = jm.loss_fn(jm.lora, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)


def test_count_params(tiny):
    """count_params equals JAX's on the dense tree, the LoRA tree and the
    NF4-quantized tree (codes and scales)."""
    jm, tm, lora_np, _ = tiny
    count = tparams_mod.count_params
    assert count(tm.params) == jparams_mod.count_params(jm.params) > 0
    assert count(tm.lora) == jparams_mod.count_params(lora_np) > 0
    assert count(tparams_mod.quantize_params(tm.params, tm.cfg)) == \
        jparams_mod.count_params(
            jparams_mod.quantize_params(jm.params, jm.cfg))
