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
from bitsandbytes_tpu_torch.parallel import make_mesh
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


_BLOCKED_SURFACE = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "safetensors", "bitsandbytes_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
import torch
from bitsandbytes_tpu_torch import nn, optim
from bitsandbytes_tpu_torch.models import gpt2 as G
g = torch.Generator().manual_seed(0)
ids = torch.tensor([[1, 2, 3]])
for mod in (nn.EmbeddingNF4(16, 64, device="cpu", generator=g), nn.EmbeddingFP4(16, 33, device="cpu", generator=g),
            nn.Embedding8bit(16, 64, device="cpu", generator=g), nn.Embedding(16, 64, device="cpu", generator=g),
            nn.StableEmbedding(16, 64, device="cpu", generator=g)):
    assert mod(ids).shape == (1, 3, mod.embedding_dim)
lin = nn.OutlierAwareLinear(64, 32, outlier_topk=4, device="cpu", generator=g)
assert lin(torch.randn(2, 64, generator=g)).shape == (2, 32)
model = torch.nn.Module()
model.embedding = nn.StableEmbedding(64, 64, device="cpu", generator=g)
model.proj = torch.nn.Linear(64, 64)
mgr = optim.GlobalOptimManager.get_instance()
mgr.register_module_override(model.embedding, "weight", {"optim_bits": 32})
for opt in (mgr.build("adam", model, optim_bits=8, min_8bit_size=64),
            optim.paged_adamw8bit(list(model.parameters()), min_8bit_size=64)):
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
cfg = G.GPT2Config.tiny()
params = G.init_params(cfg, g, device="cpu")
for tree in (params, G.quantize_params_4bit(params), G.quantize_params_int8(params)):
    assert torch.isfinite(G.forward(tree, ids, cfg)).all()
import runpy
sys.argv = ["bitsandbytes_tpu_torch", "--device", "cpu"]
try:
    runpy.run_module("bitsandbytes_tpu_torch", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
print("ok")
"""


def test_new_surface_runs_with_jax_blocked():
    """The embeddings, OutlierAwareLinear, the override and paged
    optimizers, the GPT-2/OPT model and the diagnostics CLI run with jax,
    flax, optax, ml_dtypes, safetensors and the JAX package blocked."""
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_SURFACE], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stdout + res.stderr


_MESH_TRAINING = """
import os, sys
for name in ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "safetensors", "bitsandbytes_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
import torch
import torch.distributed as dist
from bitsandbytes_tpu_torch.parallel.ring_attention import ring_attention
from bitsandbytes_tpu_torch.parallel.pipeline import gpipe, stack_stage_params
from bitsandbytes_tpu_torch.utils.benchmark import device_loop_time
from bitsandbytes_tpu_torch import parallel as P
from bitsandbytes_tpu_torch.models import llama as L
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(sys.argv[1], "store"), 1), rank=0, world_size=1)
g = torch.Generator().manual_seed(0)
cfg = L.LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=1, num_heads=2,
                    num_kv_heads=1, head_dim=32)
mesh = P.make_mesh({"data": 1, "seq": 1, "model": 1})
pmesh = P.make_mesh({"pipe": 1})
params = P.llama_param_specs(mesh, L.init_params(cfg, g, device="cpu"))
lora = L.add_lora(cfg, rank=2, device="cpu")
opt = torch.optim.SGD(L.lora_parameters(lora), 1e-3)
ids = torch.randint(0, cfg.vocab_size, (2, 9), generator=g)
q = torch.randn(1, 8, 2, 32, generator=g, requires_grad=True)
stacked = stack_stage_params([{"w": torch.randn(64, 64, generator=g)} for _ in range(2)], 1)
stacked["w"].requires_grad_()
x = torch.randn(4, 64, generator=g, requires_grad=True)
# from here a tensor made without naming its device is a "meta" tensor, which no CPU tensor can meet
torch.set_default_device("meta")
try:
    loss = L.lora_train_step(params, lora, opt, ids, cfg, token_chunk=8, mesh=mesh)
    ring_attention(q, q, q, mesh, axis="seq").sum().backward()
    gpipe(lambda p, a: torch.tanh(a @ p["w"]), stacked, x, pmesh, n_microbatches=2).sum().backward()
finally:
    torch.set_default_device(None)
out = [loss, q.grad, x.grad, stacked["w"].grad] + [t.grad for t in L.lora_parameters(lora)]
assert all(t.device.type == "cpu" and bool(torch.isfinite(t).all()) for t in out)
dist.destroy_process_group()
print("ok")
"""


def test_mesh_training_runs_with_jax_blocked_on_its_inputs_device(tmp_path):
    """``parallel.ring_attention``, ``parallel.pipeline`` and
    ``utils.benchmark.device_loop_time`` import with jax, flax, optax and the
    JAX package blocked, and the meshed entry points (a QLoRA step over a
    data x seq x model mesh, ring attention, GPipe) create nothing on the
    CPU unless asked: run on CPU inputs over a one-rank gloo group with the
    default device set to "meta", any tensor they made without naming its
    device would fail to meet the CPU ones.  (A float tree: the 4-bit
    kernels' plain versions build host tables on purpose.)"""
    res = subprocess.run(
        [sys.executable, "-c", _MESH_TRAINING, str(tmp_path)], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stdout + res.stderr


def test_virtual_mesh_raises_in_the_training_collectives(monkeypatch):
    """A virtual mesh (a coordinate, no process groups) refuses ``ppermute``
    as it refuses ``all_gather``, at any axis size, and so do ring attention
    and GPipe; ``device_loop_time`` refuses to run without a GPU."""
    from bitsandbytes_tpu_torch.parallel import gpipe, ppermute, ring_attention, stack_stage_params
    from bitsandbytes_tpu_torch.utils.benchmark import device_loop_time

    t = torch.ones(2, 4)
    for n in (1, 2):
        mesh = make_mesh({"seq": n}, coord=0)
        with pytest.raises(RuntimeError, match="virtual mesh"):
            mesh.all_gather(t, "seq")
        with pytest.raises(RuntimeError, match="virtual mesh"):
            ppermute(t, mesh, "seq")
        with pytest.raises(RuntimeError, match="virtual mesh"):
            ring_attention(t[None, :, None], t[None, :, None], t[None, :, None], mesh)
    with pytest.raises(RuntimeError, match="virtual mesh"):
        gpipe(lambda p, a: a @ p["w"], stack_stage_params([{"w": torch.eye(4)}], 1), t, make_mesh({"pipe": 1}, coord=0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_loop_time(lambda a: a, (t,))


@pytest.mark.parametrize("args,rc", [([], 1), (["--device", "cpu"], 0)], ids=["default_cuda", "cpu"])
def test_diagnostics_cli(args, rc):
    """``python -m bitsandbytes_tpu_torch``: without a GPU it says so and
    exits non-zero; ``--device cpu`` checks the plain versions and exits 0."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    res = subprocess.run([sys.executable, "-m", "bitsandbytes_tpu_torch", *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == rc, res.stdout + res.stderr
    if rc:
        assert "--device cpu" in res.stderr and "healthy" not in res.stdout
    else:
        assert "Installation looks healthy" in res.stdout and "torch:" in res.stdout


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
    engine's mesh option takes a ``parallel.Mesh`` over process groups and
    refuses anything else, a virtual mesh included."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TL.LlamaConfig(vocab_size=16, hidden_size=64, intermediate_size=64, num_layers=1,
                         num_heads=1, num_kv_heads=1, head_dim=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.init_paged_kv_cache(cfg, 1, 64, num_blocks=4, block_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine({}, cfg, max_batch=1, max_len=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.kv_cache_from_numpy({"k": None, "v": None})
    with pytest.raises(TypeError, match="parallel.Mesh"):
        ContinuousBatchingEngine({}, cfg, max_batch=1, max_len=64, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="parallel.Mesh"):
        ContinuousBatchingEngine({}, cfg, max_batch=1, max_len=64, mesh=make_mesh({"model": 1}, coord=0),
                                 device="cpu")
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
