"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points refuse to run quietly on the CPU when no GPU is there."""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from bitsandbytes_tpu_torch.models import llama as TL
from bitsandbytes_tpu_torch.nn import LinearNF4
from bitsandbytes_tpu_torch.serving import ContinuousBatchingEngine
from bitsandbytes_tpu_torch.utils import interop

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "bitsandbytes_tpu_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")

_IMPORT_ALL = """
import importlib, pkgutil, sys
before = set(sys.modules)
import bitsandbytes_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
new = set(sys.modules) - before
bad = sorted(k for k in new if k.split(".")[0] in ("jax", "jaxlib", "bitsandbytes_tpu"))
print(len(new), bad)
sys.exit(1 if bad else 0)
"""


def test_importing_every_module_loads_no_jax():
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stdout + res.stderr


_BLOCKED = """
import importlib, os, pkgutil, sys
for name in ("jax", "jaxlib", "ml_dtypes", "safetensors", "bitsandbytes_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
import torch
import bitsandbytes_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from bitsandbytes_tpu_torch.models import llama as L
from bitsandbytes_tpu_torch.utils import serialization as S
cfg = L.LlamaConfig(vocab_size=16, hidden_size=64, intermediate_size=64, num_layers=1, num_heads=1,
                    num_kv_heads=1, head_dim=64)
params = L.quantize_params_4bit(L.init_params(cfg, device="cpu"), compress_statistics=True)
d = sys.argv[1]
for save, load, name in ((S.save_checkpoint_safetensors, S.load_checkpoint_safetensors, "c.safetensors"),
                         (S.save_checkpoint, S.load_checkpoint, "c.npz")):
    save(os.path.join(d, name), params)
    back = load(os.path.join(d, name), params, device="cpu")
    assert torch.equal(back["layers"][0]["wq"].data, params["layers"][0]["wq"].data)
    assert torch.equal(back["embed"], params["embed"])
print("ok")
"""


def test_port_and_its_checkpoints_need_neither_ml_dtypes_nor_safetensors(tmp_path):
    """Every module imports, and a bf16 tree round-trips through both file
    formats, with jax, ml_dtypes, safetensors and the JAX package blocked."""
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(tmp_path)], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stdout + res.stderr


def _sources():
    for dirpath, _, files in os.walk(PKG):
        if "_build" in dirpath:
            continue
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(dirpath, f)
    yield SMOKE


@pytest.mark.parametrize("word", ["jax", "bitsandbytes_tpu"])
def test_no_source_names_the_jax_side(word):
    """No module name of the JAX side appears; a file path into the JAX
    package (``bitsandbytes_tpu/ops/...``, naming a replaced kernel) may."""
    pattern = re.compile(rf"\b{word}\b(?!/)")
    hits = []
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if pattern.search(line):
                    hits.append(f"{os.path.relpath(path, ROOT)}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TL.LlamaConfig(vocab_size=16, hidden_size=64, intermediate_size=64, num_layers=1,
                         num_heads=1, num_kv_heads=1, head_dim=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.init_kv_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LinearNF4(64, 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.params_from_numpy({})
    assert TL.init_kv_cache(cfg, 1, 8, device="cpu").k.device.type == "cpu"


def test_engine_and_paged_cache_default_device_raise_without_gpu(monkeypatch):
    """The serving engine and the paged cache default to CUDA too; the
    engine's mesh option is not ported and says so."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TL.LlamaConfig(vocab_size=16, hidden_size=64, intermediate_size=64, num_layers=1,
                         num_heads=1, num_kv_heads=1, head_dim=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.init_paged_kv_cache(cfg, 1, 64, num_blocks=4, block_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine({}, cfg, max_batch=1, max_len=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.kv_cache_from_numpy({"k": None, "v": None})
    with pytest.raises(NotImplementedError, match="slice G"):
        ContinuousBatchingEngine({}, cfg, max_batch=1, max_len=64, mesh=object(), device="cpu")
    eng = ContinuousBatchingEngine({}, cfg, max_batch=1, max_len=64, kv_layout="paged", kv_block_size=16,
                                   device="cpu")
    assert eng.cache.k.device.type == eng.cache.tables.device.type == "cpu"


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """Without a GPU the chip check exits non-zero and prints no result, in
    the checkout and in a directory that holds only the script."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cwd = ROOT
    if where == "alone":
        shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
        cwd = str(tmp_path)
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True, timeout=300
    )
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
