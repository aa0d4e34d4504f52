"""The port stands alone: importing every module of paddle_tpu_torch
(and chip_smoke.py) loads neither jax nor anything of paddle_tpu;
chip_smoke.py fails, printing no result, where there is no card; and
the entry points raise without CUDA unless the CPU is asked for."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one interpreter for both checks: importing torch is the slow part
_IMPORT_ALL_THEN_SMOKE = """
import contextlib, importlib, io, pkgutil, runpy, sys
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    paddle_tpu_torch.__path__, 'paddle_tpu_torch.')]
for n in names:
    importlib.import_module(n)
import chip_smoke
assert len(names) >= 40, names
for m in ('ops.kern.quant', 'ops.kern.layer_norm', 'ops.kern.flash_attention',
          'unique_name', 'core.dtypes', 'core.place', 'core.framework',
          'core.scope', 'core.trace', 'core.executor', 'param_attr',
          'initializer', 'layer_helper', 'layers.nn', 'layers.io',
          'layers.tensor', 'layers.sequence', 'ops.registry',
          'ops.kernels_math', 'ops.kernels_tensor', 'ops.kernels_nn',
          'ops.kernels_optim', 'core.backward', 'optimizer',
          'ops.kern.embedding', 'ops.kernels_extra', 'layers.ops',
          'models.deepfm', 'parallel', 'parallel.mesh', 'parallel.sparse',
          'parallel.parallel_executor'):
    assert 'paddle_tpu_torch.' + m in names, (m, names)
bad = [m for m in sys.modules
       if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'
       or m.startswith('jaxlib.') or m == 'paddle_tpu'
       or m.startswith('paddle_tpu.')]
assert not bad, bad
out, err = io.StringIO(), io.StringIO()
with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
    try:
        runpy.run_path('chip_smoke.py', run_name='__main__')
        code = 0
    except SystemExit as e:
        code = e.code
assert code not in (0, None), code
assert '"ok": true' not in out.getvalue(), out.getvalue()
assert 'CUDA' in err.getvalue(), err.getvalue()
print('OK', len(names))
"""


def test_port_imports_no_jax_and_chip_smoke_fails_without_a_card():
    """In a fresh interpreter: every port module and chip_smoke.py
    import without jax or paddle_tpu; then chip_smoke.py, run as a
    script where torch sees no card, exits non-zero and prints no
    result."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL_THEN_SMOKE],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("OK")


@pytest.mark.parametrize("entry", ["engine", "decoder", "params",
                                   "executor"])
def test_entry_points_raise_without_cuda_unless_cpu_is_asked(entry,
                                                             monkeypatch):
    from paddle_tpu_torch.models import transformer as ttfm
    from paddle_tpu_torch.serving.decode import (DecodeEngine,
                                                 DecodeEngineConfig)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttfm.TransformerConfig(src_vocab=8, trg_vocab=8, max_len=4,
                                 d_model=8, d_inner=8, n_head=2,
                                 n_layer=1)
    shapes = {"src_emb.w_0": (8, 8), "trg_emb.w_0": (8, 8),
              "proj.w_0": (8, 8)}
    for base in ("enc0", "dec0_self", "dec0_cross"):
        for p in "qkvo":
            shapes[f"{base}_{p}.w_0"] = (8, 8)
    for part in ("enc0_ffn", "dec0_ffn"):
        for fc in ("fc1", "fc2"):
            shapes[f"{part}_{fc}.w_0"] = (8, 8)
            shapes[f"{part}_{fc}.b_0"] = (8,)
    for j in range(5):
        shapes[f"layer_norm_{j}.w_0"] = (8,)
        shapes[f"layer_norm_{j}.b_0"] = (8,)
    params = {n: np.ones(s, np.float32) for n, s in shapes.items()}
    from paddle_tpu_torch.core.executor import Executor
    build = {
        "executor": lambda device=None: Executor(device),
        "engine": lambda **kw: DecodeEngine(
            cfg, params, DecodeEngineConfig(num_slots=2), **kw),
        "decoder": lambda **kw: ttfm.IncrementalDecoder(cfg, params, 2,
                                                        **kw),
        "params": lambda **kw: ttfm.params_from_numpy(params, cfg, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build(device="cuda")
    assert build(device="cpu") is not None


def test_parallel_executor_runs_on_the_card_unless_the_cpu_is_asked(
        monkeypatch):
    from paddle_tpu_torch import layers, optimizer, unique_name
    from paddle_tpu_torch.core import framework
    from paddle_tpu_torch.parallel import ParallelExecutor, local_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup), unique_name.guard():
        ids = layers.data("ids", shape=[2, 1], dtype="int64")
        emb = layers.embedding(ids, size=[10, 4], is_sparse=True,
                               is_distributed=True)
        optimizer.SGD(0.1).minimize(layers.mean(emb))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParallelExecutor(main_program=main, sparse="shard")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        local_mesh()
    pexe = ParallelExecutor(use_cuda=False, main_program=main,
                            sparse="shard")
    assert pexe.sparse_engine.device == torch.device("cpu")


def test_resolve_device_takes_cpu_without_touching_torch_state():
    from paddle_tpu_torch.device import resolve_device
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.get_default_dtype())
    assert resolve_device("cpu") == torch.device("cpu")
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_default_dtype()) == before
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
