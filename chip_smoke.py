#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, `paddle_tpu_torch`, on one
NVIDIA GPU (written for the H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every kernel of the port from `paddle_tpu_torch/csrc/` (one
`nvcc` per source, all at once) and holds each kernel against its plain
PyTorch version on the card. Then it drives these paths with random
weights made from a seed:

- Transformer-base greedy decode through `ContinuousScheduler` ->
  `DecodeEngine` -> `IncrementalDecoder`, with the fp32 KV cache
  (kernel `decode_attend`) and with the int8 cache (kernels
  `quantize_int8_blockwise` and `dequant_attend`);
- Transformer-base inference through the Fluid Program and Executor:
  `build_infer_program` built with the port's layers, `run_startup`,
  then `greedy_decode` through `Executor.run` (kernels `layer_norm` and
  `flash_attention`);
- the Transformer-base training step (fp32, Adam) through the Program
  and Executor: `build_program`, `optimizer.Adam(1e-3).minimize`,
  `run_startup`, then `Executor.run` of the training program on the
  copy task at (B, T) = (64, 128) (kernels `flash_attention`,
  `flash_attention_dq`, `flash_attention_dkv`, `layer_norm` and
  `layer_norm_bwd`);
- DeepFM CTR training at bench.py --sparse's configuration through the
  sharded embedding engine, `ParallelExecutor(sparse="shard")`, on the
  card: vocab 1e8, B 512, 26 fields, embed_dim 8, SGD, the tables
  seeded on the card by `init_shards` (kernel `lookup_pool`, twice a
  step); and DeepFM at bench.py's deepfm configuration (vocab 8e6,
  B 4096, embed_dim 16, Adam) through the plain Executor's `is_sparse`
  path, which runs no kernel of the port.

For each path it checks that every step went through its kernels. It
compares the card's logits, tokens, losses and trained parameters with
the port's CPU run, the int8 cache with the fp32 cache on the card, and
times each kernel beside its bound, its plain version and, where one
exists, a PyTorch library call.

It imports nothing of JAX or of `paddle_tpu`. Where CUDA is not
available, or any phase fails, it exits non-zero and prints no result.
Its last two lines are a JSON object of per-kernel numbers and then
``{"ok": true, "device": {...}}``.
"""
import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

SEED = 20261016
# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# kernel against its plain version, both fp32 on the card: the kernel
# sums in another order (online softmax, per-warp partials)
KERNEL_ATOL = 1e-5
# card against CPU, whole model in fp32 (TF32 off): cuBLAS and the CPU
# BLAS sum in different orders through 6 layers and a 10000-way
# projection; logits are O(10)
LOGIT_ATOL = 2e-3
# card against CPU with the int8 cache: K/V differ by ~1e-7 relative,
# so an element near a .5 boundary of x / scale gets a code one step
# apart on the two sides; one such flip moves one K or V element by
# 1/127 of its block's absmax. Codes may differ by one step in at most
# INT8_CODE_SHARE of the cache, logits by INT8_LOGIT_ATOL, and a token
# only where the CPU logits' top-two margin is below INT8_LOGIT_ATOL.
INT8_CODE_SHARE = 0.01
INT8_LOGIT_ATOL = 2e-2
# int8 cache against fp32 cache on the card, teacher-forced: the JAX
# package's own bounds (tests/test_serving_farm.py, greedy)
INT8_VS_FP32_TOKEN_SHARE = 0.02
INT8_VS_FP32_LOGIT = 0.5
# the Program path, card against CPU, fp32: 6 encoder and 6 decoder
# layers over 128 positions, cuBLAS and the CPU BLAS summing in
# different orders; logits are O(10). Tokens may differ only where the
# CPU logits' top-two margin is below it.
PROGRAM_LOGIT_ATOL = 2e-3
# backward kernels against their plain versions, both fp32 on the card,
# as numpy's allclose (|a - b| <= atol + rtol |b|): the JAX package's own
# gradient tolerances, tests/test_flash_attention.py:74-78 (flash dq, dk,
# dv) and tests/test_pallas_layer_norm.py:57 (LayerNorm dx, dscale,
# dbias)
FLASH_GRAD_TOL = 1e-4
LN_GRAD_TOL = 2e-4
# the training step, card against CPU from one scope, fp32, dropout 0,
# 3 steps. Each step runs on the card from the CPU's state (teacher
# forcing), and is held to the CPU's step in three parts:
# - the loss within tests/test_flash_attention.py:144's 2e-4;
# - each parameter's gradient, tensor by tensor: |diff| within
#   TRAIN_GRAD_RTOL of that tensor's largest gradient plus
#   TRAIN_GRAD_FLOOR (one fp32 rounding) of the step's largest, the
#   floor for tensors whose gradient is rounding noise (cross
#   attention's q weights, whose largest falls to 1e-11 of the step's
#   largest); at most TRAIN_OUTLIER_SHARE of a tensor's elements may lie
#   outside. Outliers come from a ReLU whose input lies within rounding
#   of 0: the card and the CPU pass its gradient on different sides,
#   which moves that unit's fc1 bias element and fc1 weight column by one
#   token's share; the share admits two such units in one layer (2 of
#   an fc1 bias's 2048 elements) and no outlier in a tensor of fewer
#   than 1000 elements;
# - the Adam tail: every parameter and moment the card writes equals
#   the port's `adam` op run on the CPU from the step's state and the
#   card's own gradients, within TRAIN_ADAM_RTOL (a few fp32 roundings)
#   of the value, or of lr for parameters and of the tensor's largest
#   for moments; the beta powers and the learning rate are identical.
#   (Against the CPU's parameters no tight bound holds: Adam divides by
#   |g| + eps, so an element whose gradient is within rounding of 0
#   moves by up to lr either way.)
# The card and the CPU must each repeat step 1 bit for bit.
TRAIN_LOSS_TOL = 2e-4
TRAIN_GRAD_RTOL = 1e-3
TRAIN_GRAD_FLOOR = 2.0 ** -23
TRAIN_OUTLIER_SHARE = 1e-3
TRAIN_ADAM_RTOL = 1e-6
# the training configuration of bench.py:302-306, fp32
TRAIN_B, TRAIN_T, TRAIN_LR = 64, 128, 1e-3
# an idle share (1 - device busy / host wall, one profiled window) below
# -IDLE_NOISE fails: see idle_share
IDLE_NOISE = 0.01


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# -------------------------------------------------------------- helpers
def base_params(tfm, cfg, seed):
    """Unfused Transformer parameters at the config's widths, drawn
    from `seed` with wide values (std 2/sqrt(fan_in), layer-norm scales
    1 +- 0.2, biases 0.1), so argmax varies from token to token."""
    D = cfg.d_model
    shapes = tfm.param_shapes(cfg)
    rng = np.random.default_rng(seed)
    out = {}
    for n in sorted(shapes):
        shp = shapes[n]
        a = rng.standard_normal(shp, dtype=np.float32)
        if n.startswith("layer_norm") and n.endswith(".w_0"):
            a = 1.0 + 0.2 * a
        elif n.endswith(".b_0"):
            a = 0.1 * a
        elif n.endswith("_emb.w_0"):
            a *= 2.0 / np.sqrt(D)
        else:
            a *= 2.0 / np.sqrt(shp[0])
        out[n] = a.astype(np.float32)
    return out


def device_ms(torch, fn, n_iter):
    """Device time of one call of `fn(i)`, in ms. A sleep kernel holds
    the stream while the host enqueues all the calls, so the events
    time the device's work and not the host's launch rate."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))
    e0.record()
    for i in range(n_iter):
        fn(i)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n_iter


def profile_window(torch, fn, n, warm):
    """`fn()` `warm` times, then n times unprofiled and n times under
    torch.profiler, each window ending with a synchronize: (host wall
    ms per call unprofiled, host wall ms per call profiled, {device
    kernel name: us per call} of the profiled window). A window in
    which the profiler sees no device time fails the run: the idle share
    and the device time by kernel are measurements the run must make."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t) / n * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / n
    check(sum(by_name.values()) > 0,
          "torch.profiler saw no device time in its window")
    return wall_ms, prof_ms, by_name


def idle_share(busy_us, prof_ms, what):
    """1 - device busy / host wall, both of the profiled window,
    unclamped. The port launches on one stream, so its kernels do not
    overlap and busy time exceeds the wall only by the error of the
    profiler's alignment of the device's clock to the host's: a share
    below -IDLE_NOISE fails."""
    share = 1 - busy_us / 1e3 / prof_ms
    check(share >= -IDLE_NOISE,
          f"{what}: device busy {busy_us / 1e3:.3f} ms exceeds the "
          f"profiled wall {prof_ms:.3f} ms")
    return share


# --------------------------------------------------------------- phases
def _ptxas_summary(out):
    """'regs a-b, spill stores x B, spill loads y B' from -Xptxas -v."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", out)]
    st = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", out))
    ld = sum(int(b) for b in re.findall(r"(\d+) bytes spill loads", out))
    if not regs:
        return "no ptxas report (library was already built)"
    return (f"{len(regs)} kernels, regs {min(regs)}-{max(regs)}, spill "
            f"stores {st} B, spill loads {ld} B")


def phase_device_and_build(torch, _build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[device] {torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda} python={sys.version.split()[0]}")
    t0 = time.perf_counter()
    built = _build.build()
    for name in built:
        _build.load(name)
    for name, (sec, out) in built.items():
        log(f"[build] {os.path.relpath(_build.CSRC)}/{name}.cu: nvcc "
            f"{sec:.2f} s; {_ptxas_summary(out)}")
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}; {len(built)} "
        f"sources in parallel, build and load: "
        f"{time.perf_counter() - t0:.2f} s")
    return card


def phase_layer_norm_vs_plain(torch, ln, dev):
    """The LayerNorm kernel against its plain version on the card: at
    the Program path's shape ([16, 128, 512]: 2048 rows of 512), at C
    64, 2048 and 8192, on 7 rows, with a batch dim of 1, in fp32 and
    bf16. mean and var (f32) and fp32 y within KERNEL_ATOL. A bf16 y is
    held to one bf16 step, not KERNEL_ATOL: the kernel's and the plain
    version's f32 values may straddle a rounding boundary. The f32
    arithmetic of the bf16 case is held to KERNEL_ATOL through the fp32
    kernel run on the same, bf16-rounded, input (`x.float()`), against
    the plain version on that input and against the bf16 run's mean and
    var; the bf16 y is within one step of that run's y too."""
    rng = np.random.default_rng(SEED + 12)
    worst = 0.0
    for shape in ((16, 128, 512), (300, 64), (300, 2048), (40, 8192),
                  (7, 512), (1, 128, 512)):
        C = shape[-1]
        x32 = torch.from_numpy((rng.standard_normal(shape, dtype=np.float32)
                                * 3.0 + 0.5).astype(np.float32)).to(dev)
        g = torch.from_numpy((1 + 0.2 * rng.standard_normal(
            C, dtype=np.float32)).astype(np.float32)).to(dev)
        b = torch.from_numpy((0.1 * rng.standard_normal(C, dtype=np.float32)
                              ).astype(np.float32)).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            y, mean, var = ln.layer_norm(x, g, b, 1e-5)
            torch.cuda.synchronize()
            py, pm, pv = ln.layer_norm_plain(x, g, b, 1e-5)
            torch.cuda.synchronize()
            check(y.dtype == dt and tuple(y.shape) == shape
                  and tuple(mean.shape) == shape[:-1]
                  and tuple(var.shape) == shape[:-1], "layer_norm shapes")
            e_stats = max(float((mean - pm).abs().max()),
                          float((var - pv).abs().max()))
            e_y = float((y.float() - py.float()).abs().max())
            if dt == torch.float32:
                err = max(e_stats, e_y)
                note = ""
            else:
                # one bf16 step at |v| is at most |v| * 2**-7
                step = (py.float().abs() * 2.0 ** -7).clamp_min(2.0 ** -133)
                apart = int(((y.float() - py.float()).abs() > 0).sum())
                check(bool(((y.float() - py.float()).abs()
                            <= step + KERNEL_ATOL).all()),
                      "bf16 layer_norm more than one bf16 step apart")
                xr = x.float()      # exact: the bf16 run's own input
                ky, km, kv = ln.layer_norm(xr, g, b, 1e-5)
                torch.cuda.synchronize()
                ry, rm, rv = ln.layer_norm_plain(xr, g, b, 1e-5)
                e_f32 = max(float((ky - ry).abs().max()),
                            float((km - rm).abs().max()),
                            float((kv - rv).abs().max()),
                            float((mean - km).abs().max()),
                            float((var - kv).abs().max()))
                check(bool(((y.float() - ky).abs()
                            <= (ky.abs() * 2.0 ** -7).clamp_min(2.0 ** -133)
                            + KERNEL_ATOL).all()),
                      "bf16 layer_norm more than one bf16 step from the "
                      "fp32 kernel on its input")
                err = max(e_stats, e_f32)
                note = (f" bf16 y: {apart} of {y.numel()} one rounding step "
                        f"apart, max |diff| {e_y:.3e}; f32 arithmetic on "
                        f"the bf16 input {e_f32:.3e}")
            log(f"[kernel] layer_norm x={list(shape)} {str(dt)[6:]}: max "
                f"|err| mean/var={e_stats:.3e} y={e_y:.3e}{note} (bound "
                f"{KERNEL_ATOL:.0e})")
            check(err <= KERNEL_ATOL, f"layer_norm disagrees: {err}")
            worst = max(worst, err)
    return worst


def phase_flash_vs_plain(torch, fa, dev):
    """The flash kernel against its plain version on the card, out and
    lse within KERNEL_ATOL: at the Program path's shape (B 16, H 8,
    T = S = 128, D 64, layout bthd) with and without the pad bias,
    causal and not; cross attention with T != S; lengths 37 and 50 that
    are not tile multiples; D 32 and 128; the bhtd layout; the other
    bias shapes; and a negative causal_offset, compared on the rows that
    keep at least one key."""
    rng = np.random.default_rng(SEED + 13)
    worst = 0.0
    cases = [(16, 8, 128, 128, 64, "bthd", bias, causal, 0)
             for bias in (None, "b11s") for causal in (False, True)]
    cases += [(16, 8, 128, 96, 64, "bthd", "b11s", False, 0),
              (4, 8, 50, 37, 64, "bthd", "bs", False, 0),
              (4, 8, 37, 50, 64, "bthd", "b11s", True, 0),
              (4, 8, 128, 128, 32, "bthd", "b11s", True, 0),
              (4, 8, 128, 128, 128, "bhtd", "1s", False, 0),
              (4, 8, 96, 128, 64, "bhtd", "111s", True, 0),
              (4, 8, 128, 128, 64, "bthd", "b11s", True, -1),
              (2, 4, 50, 37, 64, "bhtd", None, True, -5)]
    for B, H, T, S, D, layout, bias_kind, causal, off in cases:
        def mk(n):
            shp = (B, H, n, D) if layout == "bhtd" else (B, n, H, D)
            return torch.from_numpy(rng.standard_normal(
                shp, dtype=np.float32)).to(dev)
        q, k, v = mk(T), mk(S), mk(S)
        bias = None
        if bias_kind is not None:
            lens = rng.integers(1, S + 1, B)
            lens[0] = S
            keep = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
            pad = keep * 1e9 - 1e9
            bias = {"b11s": pad[:, None, None, :], "bs": pad,
                    "1s": pad[:1], "111s": pad[:1, None, None, :]}[bias_kind]
            bias = torch.from_numpy(np.ascontiguousarray(bias)).to(dev)
        out, lse = fa.flash_attention(q, k, v, bias, causal, D ** -0.5, off,
                                      layout)
        torch.cuda.synchronize()
        pout, plse = fa.flash_attention_plain(q, k, v, bias, causal,
                                              D ** -0.5, off, layout)
        torch.cuda.synchronize()
        rows = np.arange(T) + (S - T + off if causal else S) >= 0
        rows_t = torch.from_numpy(rows).to(dev)
        o, po = (x if layout == "bhtd" else x.transpose(1, 2)
                 for x in (out, pout))
        e_out = float((o - po)[:, :, rows_t].abs().max())
        e_lse = float((lse - plse)[:, :, rows_t].abs().max())
        check(bool(torch.isfinite(o[:, :, rows_t]).all()), "flash not finite")
        log(f"[kernel] flash_attention B={B} H={H} T={T} S={S} D={D} "
            f"{layout} bias={bias_kind} causal={causal} offset={off} "
            f"rows compared={int(rows.sum())}: max |err| out={e_out:.3e} "
            f"lse={e_lse:.3e} (bound {KERNEL_ATOL:.0e})")
        check(max(e_out, e_lse) <= KERNEL_ATOL,
              f"flash disagrees: out {e_out}, lse {e_lse}")
        worst = max(worst, e_out, e_lse)
    return worst


def phase_kernel_vs_plain(torch, da, dev):
    """The kernel against its plain version on the card, at the main
    path's shape, a deep pool and two other head widths."""
    worst = 0.0
    rng = np.random.default_rng(SEED + 1)
    for S, T, H, Dh in ((32, 256, 8, 64), (32, 2048, 8, 64),
                        (32, 256, 8, 16), (32, 256, 8, 128)):
        pos = rng.integers(0, T, S).astype(np.int32)
        pos[:5] = (-1, 0, T - 1, T, T + 7)
        q, k, v = (torch.from_numpy(rng.standard_normal(
            shp, dtype=np.float32)).to(dev)
            for shp in ((S, H, Dh), (S, T, H, Dh), (S, T, H, Dh)))
        pos_t = torch.from_numpy(pos).to(dev)
        got = da.decode_attend(q, k, v, pos_t)
        torch.cuda.synchronize()
        ref = da.decode_attend_plain(q, k, v, pos_t)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "kernel output not finite")
        check(not bool(got[0].any()), "pos -1 must give a zero row")
        err = float((got - ref).abs().max())
        log(f"[kernel] decode_attend S={S} T={T} H={H} Dh={Dh} "
            f"pos[:5]={pos[:5].tolist()} max_abs_err={err:.3e} "
            f"(bound {KERNEL_ATOL:.0e})")
        check(err <= KERNEL_ATOL, f"kernel disagrees with plain: {err}")
        worst = max(worst, err)
    return worst


def phase_quant_vs_plain(torch, qt, dev):
    """The quantize kernel against its plain version on the card, bit
    for bit: at the main path's shape (one [32, 8, 64] row set in blocks
    of 64), at block sizes 4, 256 and the largest, on blocks that hold
    an all-zero block, values whose quotient x / scale lies exactly on
    k + 0.5 (half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2), and a NaN. The
    NaN's block must get a NaN scale from both; its codes come from
    casting NaN to int8, implementation-defined in the reference too,
    and are not compared. Every other block is bit-identical."""
    rng = np.random.default_rng(SEED + 6)
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -125.5],
                      np.float32)
    worst = 0.0
    for n, bs in ((32 * 8 * 64, 64), (4 * 64, 4), (256 * 40, 256),
                  (qt.MAX_BLOCK * 12, qt.MAX_BLOCK)):
        x = (rng.standard_normal(n, dtype=np.float32)
             * np.repeat(np.exp(rng.uniform(-6, 4, n // bs)), bs)
             ).astype(np.float32)
        x[:bs] = 0.0
        for b, unit in ((1, 1.0), (2, 2.0), (3, 0.5)):
            blk = np.resize(halves, bs) * unit
            blk[-1] = 127.0 * unit
            x[b * bs:(b + 1) * bs] = blk
        x[4 * bs + bs // 2] = np.nan       # block 4 holds a NaN
        xt = torch.from_numpy(x).to(dev)
        codes, scales = qt.quantize_int8_blockwise(xt, bs)
        torch.cuda.synchronize()
        pc, ps = qt.quantize_int8_blockwise_plain(xt, bs)
        check(codes.dtype == torch.int8 and scales.dtype == torch.float32
              and tuple(codes.shape) == (n // bs, bs)
              and tuple(scales.shape) == (n // bs, 1), "quantize shapes")
        nan_k, nan_p = float(scales[4, 0]), float(ps[4, 0])
        check(np.isnan(nan_k) and np.isnan(nan_p),
              f"the NaN block's scale must be NaN: kernel {nan_k}, plain "
              f"{nan_p}")
        other = torch.ones(n // bs, dtype=torch.bool, device=dev)
        other[4] = False
        codes, pc, scales, ps = codes[other], pc[other], scales[other], \
            ps[other]
        same_c = bool(torch.equal(codes, pc))
        same_s = bool(torch.equal(scales, ps))
        err_c = int((codes.int() - pc.int()).abs().max())
        err_s = float((scales - ps).abs().max())
        worst = max(worst, err_c, err_s)
        ties = codes[1, :min(bs, 8)].tolist()
        log(f"[kernel] quantize_int8_blockwise n={n} block_size={bs}: "
            f"codes identical={same_c} (max |diff| {err_c}) scales "
            f"identical={same_s} (max |diff| {err_s:.3e}) outside the NaN "
            f"block, whose scales are kernel {nan_k} and plain {nan_p}; "
            f"zero block scale={float(scales[0, 0])} tie codes={ties}")
        check(same_c and same_s, "quantize kernel is not bit-identical "
              "to its plain version")
        check(float(scales[0, 0]) == 0.0 and not bool(codes[0].any()),
              "zero block must store scale 0 and codes 0")
    return worst


def phase_dequant_vs_plain(torch, da, qt, dev):
    """The int8 attention kernel against its plain version on the card,
    on caches quantized from random K/V by the plain quantizer, at head
    widths 16, 64 and 128 with one scale per row and several."""
    worst = 0.0
    rng = np.random.default_rng(SEED + 7)
    for S, T, H, Dh, kvb in ((32, 256, 8, 64, 64), (32, 256, 8, 64, 16),
                             (32, 256, 8, 16, 16), (32, 256, 8, 16, 4),
                             (32, 256, 8, 128, 128), (32, 256, 8, 128, 32),
                             (32, 2048, 8, 64, 64)):
        pos = rng.integers(0, T, S).astype(np.int32)
        pos[:5] = (-1, 0, T - 1, T, T + 7)
        q = torch.from_numpy(rng.standard_normal(
            (S, H, Dh), dtype=np.float32)).to(dev)
        cache = []
        for _ in range(2):
            x = torch.from_numpy(rng.standard_normal(
                S * T * H * Dh, dtype=np.float32)).to(dev)
            c, sc = qt.quantize_int8_blockwise_plain(x, kvb)
            cache += [c.reshape(S, T, H, Dh),
                      sc.reshape(S, T, H, Dh // kvb)]
        kq, ks, vq, vs = cache
        pos_t = torch.from_numpy(pos).to(dev)
        got = da.dequant_attend(q, kq, ks, vq, vs, pos_t)
        torch.cuda.synchronize()
        ref = da.dequant_attend_plain(q, kq, ks, vq, vs, pos_t)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "kernel output not finite")
        check(not bool(got[0].any()), "pos -1 must give a zero row")
        err = float((got - ref).abs().max())
        log(f"[kernel] dequant_attend S={S} T={T} H={H} Dh={Dh} "
            f"kv_block={kvb} (nb={Dh // kvb}) pos[:5]={pos[:5].tolist()} "
            f"max_abs_err={err:.3e} (bound {KERNEL_ATOL:.0e})")
        check(err <= KERNEL_ATOL, f"kernel disagrees with plain: {err}")
        worst = max(worst, err)
    return worst


def phase_serving(torch, kern, tfm, dec_mod, params, cfg, kv_quant=None):
    """Transformer-base continuous decode on the card: 48 requests of
    mixed source lengths and budgets, half of them arriving while the
    first half is in flight, with the fp32 or the int8 KV cache. Every
    launch count is set to 0 just before the run and read just after:
    each decode step must launch the cache's kernels once per layer
    (quantize twice, for K and V) and every other kernel never."""
    engine = dec_mod.DecodeEngine(
        cfg, params, dec_mod.DecodeEngineConfig(num_slots=32, max_len=256,
                                                kv_quant=kv_quant))
    sched = dec_mod.ContinuousScheduler(
        engine, config=dec_mod.DecodeConfig(bos=0, eos=None))
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    steps = []                  # pos of every decode step
    spent = {"step": 0.0, "admit": 0.0}     # host seconds, synchronized
    inner_step, inner_admit = engine.step, engine.admit

    def step(state, ids, pos, seed=0):
        steps.append(np.array(pos, np.int64))
        t = time.perf_counter()
        out = inner_step(state, ids, pos, seed=seed)    # ends in a sync
        spent["step"] += time.perf_counter() - t
        return out

    def admit(state, requests, slots):
        t = time.perf_counter()
        out = inner_admit(state, requests, slots)
        torch.cuda.synchronize()
        spent["admit"] += time.perf_counter() - t
        return out
    engine.step, engine.admit = step, admit

    rng = np.random.default_rng(SEED + 2)
    reqs = []
    for _ in range(48):
        n = int(rng.integers(8, 65))
        reqs.append((rng.integers(2, cfg.src_vocab, n), n,
                     int(rng.integers(8, 97))))
    for name in kern.LAUNCHES:
        kern.LAUNCHES[name] = 0
    steps.clear()
    spent.update(step=0.0, admit=0.0)
    t0 = time.perf_counter()
    futs = []
    try:
        sched.start()
        for src, n, m in reqs[:24]:
            futs.append(sched.submit(src, src_len=n, max_new_tokens=m))
        deadline = time.monotonic() + 120
        while sched.tokens_generated == 0:
            check(time.monotonic() < deadline, "no token within 120 s")
            time.sleep(0.002)
        in_flight = sched.pool.active_count()
        for src, n, m in reqs[24:]:
            futs.append(sched.submit(src, src_len=n, max_new_tokens=m))
        results = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sched.stop(drain=True, timeout=60)
    launches = dict(kern.LAUNCHES)
    check(not sched.alive, "decode loop still running after stop")
    tokens = 0
    for (src, n, m), r in zip(reqs, results):
        check(r.finish_reason == "length" and len(r.tokens) == m,
              f"request got {len(r.tokens)} of {m} tokens")
        check(int(r.tokens.min()) >= 0
              and int(r.tokens.max()) < cfg.trg_vocab, "token id range")
        tokens += len(r.tokens)
    distinct = len(np.unique(np.concatenate([r.tokens for r in results])))
    streams = len({r.tokens.tobytes() for r in results})
    L, n = cfg.n_layer, len(steps)
    want = {k: 0 for k in launches}
    want.update({"dequant_attend": L * n,
                 "quantize_int8_blockwise": 2 * L * n}
                if kv_quant == "int8" else {"decode_attend": L * n})
    log(f"[serve] Transformer-base d_model={cfg.d_model} "
        f"d_inner={cfg.d_inner} heads={cfg.n_head} layers={cfg.n_layer} "
        f"vocab={cfg.trg_vocab}; slots=32 max_len=256 "
        f"kv_quant={kv_quant or 'fp32'} kv_cache_bytes="
        f"{engine.kv_cache_bytes}: "
        f"requests={len(results)} tokens={tokens} "
        f"distinct_tokens={distinct} distinct_streams={streams} "
        f"in_flight_at_second_wave={in_flight} "
        f"wall_s={wall:.3f} tokens_per_s={tokens / wall:.1f} "
        f"decode_steps={n} LAUNCHES={launches} (required {want}); host "
        f"time in steps_s={spent['step']:.3f} (mean_step_ms="
        f"{spent['step'] / max(1, n) * 1e3:.3f}) "
        f"admit_prefill_s={spent['admit']:.3f} "
        f"rest_s={wall - spent['step'] - spent['admit']:.3f}")
    check(in_flight > 0, "second wave did not arrive mid-flight")
    check(distinct > 1 and streams > 1, "every request decoded alike")
    check(n > 0 and launches == want,
          f"LAUNCHES {launches} != {want} for {n} steps")
    return launches, steps, engine


def phase_step_profile(torch, engine, pick, cfg):
    """Where one decode step's time goes with all 32 slots live at the
    serving run's median positions: host wall per step, device busy
    time per step from torch.profiler, idle share in the profiled
    window, and the kernels that take it
    (the port's own: `attend_kernel` and `quantize_kernel`)."""
    dec = engine.decoder
    S, Ts = dec.num_slots, dec.src_max_len
    rng = np.random.default_rng(SEED + 5)
    lens = rng.integers(8, 65, S)
    src = np.zeros((S, Ts), np.int64)
    for r, n in enumerate(lens):
        src[r, :n] = rng.integers(2, cfg.src_vocab, n)
    state = dec.write_slots(dec.init_state(), dec.prefill(src, lens),
                            list(range(S)))
    ids = rng.integers(2, cfg.trg_vocab, S)
    wall_ms, prof_ms, by_name = profile_window(
        torch, lambda: dec.step(state, ids, pick), n=20, warm=3)
    busy_us = sum(by_name.values())
    cache = dec.kv_quant or "fp32"
    share = idle_share(busy_us, prof_ms, f"{cache} decode step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    ours = "; ".join(
        f"{kname} {us:.2f} us/step ({us / busy_us:.3f} of device time)"
        for kname, us in (
            (kname, sum(v for k, v in by_name.items() if kname in k))
            for kname in ("attend_kernel", "quantize_kernel")) if us)
    log(f"[profile] {cache} decode step, 32 live slots, attended_rows="
        f"{int(np.minimum(pick + 1, dec.max_len).sum())}: host wall "
        f"{wall_ms:.3f} ms/step unprofiled, {prof_ms:.3f} ms/step "
        f"profiled; device busy {busy_us / 1e3:.3f} ms/step -> idle share "
        f"{share:.3f} (profiled window; "
        f"{1 - busy_us / 1e3 / wall_ms:.3f} against the unprofiled wall); "
        f"{ours}; top device ops us/step: "
        + "; ".join(f"{k[:60]}={v:.1f}" for k, v in top))


def phase_card_vs_cpu(tfm, params, cfg):
    """The card's decode against the port's CPU run (plain versions)
    from the same params: logits within LOGIT_ATOL, tokens identical."""
    rng = np.random.default_rng(SEED + 3)
    S, T = 4, 256
    src = np.zeros((S, T), np.int64)
    lens = np.array([5, 17, 40, 64], np.int64)
    for r, n in enumerate(lens):
        src[r, :n] = rng.integers(2, cfg.src_vocab, n)
    decs = [tfm.IncrementalDecoder(cfg, params, S, max_len=T,
                                   return_logits=True, device=d)
            for d in (None, "cpu")]
    states = [d.write_slots(d.init_state(), d.prefill(src, lens),
                            list(range(S))) for d in decs]
    ids = np.zeros(S, np.int64)
    pos = np.array([0, 3, 9, 1], np.int64)   # slots at their own depths
    worst, scale = 0.0, 0.0
    for _ in range(8):
        out = [d.step(st, ids, pos) for d, st in zip(decs, states)]
        diff = float(np.abs(decs[0].last_logits
                            - decs[1].last_logits).max())
        worst = max(worst, diff)
        scale = max(scale, float(np.abs(decs[1].last_logits).max()))
        check(np.array_equal(out[0], out[1]),
              f"card tokens {out[0]} != cpu tokens {out[1]}")
        ids, pos = out[0].astype(np.int64), pos + 1
    log(f"[card-vs-cpu] {S} slots x 8 steps: greedy tokens identical; "
        f"max |logit diff|={worst:.3e} (bound {LOGIT_ATOL:.0e}, "
        f"max |logit|={scale:.2f})")
    check(worst <= LOGIT_ATOL, f"logits differ by {worst}")


def _decoders(tfm, params, cfg, S, T, seed, specs):
    """One decoder for each dict of keyword arguments in `specs` (device
    None = the card), each with S slots prefilled from the same random
    sources, and their states."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(5, 65, S)
    src = np.zeros((S, T), np.int64)
    for r, n in enumerate(lens):
        src[r, :n] = rng.integers(2, cfg.src_vocab, n)
    decs = [tfm.IncrementalDecoder(cfg, params, S, max_len=T,
                                   return_logits=True, **kw)
            for kw in specs]
    states = [d.write_slots(d.init_state(), d.prefill(src, lens),
                            list(range(S))) for d in decs]
    return decs, states


def phase_int8_card_vs_cpu(tfm, params, cfg):
    """The card's int8 decode against the port's CPU run (plain
    versions) from the same params, teacher-forced on the CPU's tokens:
    logits within INT8_LOGIT_ATOL, a token differing only where the CPU
    logits' top-two margin is below it, and the written cache codes at
    most one step apart in at most INT8_CODE_SHARE of them."""
    S, T, n_steps = 4, 256, 8
    decs, states = _decoders(tfm, params, cfg, S, T, SEED + 8,
                             [dict(kv_quant="int8"),
                              dict(kv_quant="int8", device="cpu")])
    ids = np.zeros(S, np.int64)
    pos0 = np.array([0, 3, 9, 1], np.int64)   # slots at their own depths
    pos = pos0.copy()
    worst, flips, close = 0.0, 0, 0
    for _ in range(n_steps):
        card, cpu = (d.step(st, ids, pos) for d, st in zip(decs, states))
        lg_card, lg_cpu = decs[0].last_logits, decs[1].last_logits
        worst = max(worst, float(np.abs(lg_card - lg_cpu).max()))
        top2 = np.sort(lg_cpu, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        close += int((margin < INT8_LOGIT_ATOL).sum())
        differ = card != cpu
        check(bool(np.all(margin[differ] < INT8_LOGIT_ATOL)),
              f"int8 card token {card} != cpu {cpu} at top-two margins "
              f"{margin}")
        flips += int(differ.sum())
        ids, pos = cpu.astype(np.int64), pos + 1
    written = np.zeros((S, T), bool)
    for s in range(S):
        written[s, pos0[s]:pos0[s] + n_steps] = True
    n_codes, apart, far = 0, 0, 0
    for name in ("kc_q", "vc_q"):
        a = states[0][name].cpu().numpy()[:, written].astype(np.int32)
        b = states[1][name].numpy()[:, written].astype(np.int32)
        n_codes += a.size
        apart += int((a != b).sum())
        far += int((np.abs(a - b) > 1).sum())
    log(f"[card-vs-cpu int8] {S} slots x {n_steps} steps, teacher-forced "
        f"on the CPU's tokens: max |logit diff|={worst:.3e} (bound "
        f"{INT8_LOGIT_ATOL:.0e}); tokens differing={flips} (allowed only "
        f"under the margin; {close} slot-steps were under it); written "
        f"codes one step apart={apart} of {n_codes}, more than one "
        f"step={far}")
    check(worst <= INT8_LOGIT_ATOL, f"int8 logits differ by {worst}")
    check(far == 0 and apart <= INT8_CODE_SHARE * n_codes,
          f"int8 codes: {apart} one step apart, {far} further")


def phase_int8_vs_fp32(tfm, params, cfg):
    """The int8 cache against the fp32 cache, both on the card, 32
    slots x 24 steps teacher-forced on the fp32 tokens: greedy tokens
    differ in at most 2 % of slot-steps and logits by less than 0.5,
    the JAX package's own bounds for its int8 cache."""
    S, T, n_steps = 32, 256, 24
    decs, states = _decoders(tfm, params, cfg, S, T, SEED + 9,
                             [dict(), dict(kv_quant="int8")])
    ids = np.zeros(S, np.int64)
    pos = np.arange(S, dtype=np.int64) % 8
    worst, flips = 0.0, 0
    for _ in range(n_steps):
        f32, i8 = (d.step(st, ids, pos) for d, st in zip(decs, states))
        worst = max(worst, float(np.abs(decs[0].last_logits
                                        - decs[1].last_logits).max()))
        flips += int((f32 != i8).sum())
        ids, pos = f32.astype(np.int64), pos + 1
    share = flips / (S * n_steps)
    log(f"[int8-vs-fp32] card, {S} slots x {n_steps} steps, "
        f"teacher-forced on the fp32 tokens: tokens differing="
        f"{flips} ({share:.4f}; bound {INT8_VS_FP32_TOKEN_SHARE}), max "
        f"|logit diff|={worst:.3e} (bound {INT8_VS_FP32_LOGIT})")
    check(share <= INT8_VS_FP32_TOKEN_SHARE,
          f"int8 tokens differ in {share:.4f} of slot-steps")
    check(worst < INT8_VS_FP32_LOGIT, f"int8 logits drift by {worst}")


def median_step(steps, T):
    """The pos vector of the serving run's median step by attended
    rows."""
    rows = [int(np.minimum(p + 1, T).sum()) for p in steps]
    return steps[int(np.argsort(rows)[len(rows) // 2])]


def phase_times(torch, da, steps, cfg, dev):
    """Kernel, plain and library times at the main path's shape, on
    the serving run's median decode step (its pos vector). The timed
    calls cycle through L cache copies whose attended rows together
    exceed four times the L2 cache, so each call reads its rows from
    HBM, as the bound assumes."""
    S, T, H = 32, 256, cfg.n_head
    Dh = cfg.d_model // H
    pick = median_step(steps, T)
    n_rows = int(np.minimum(pick + 1, T).sum())
    L, l2 = _l2_copies(torch, dev, 2 * n_rows * H * Dh * 4)
    rng = np.random.default_rng(SEED + 4)
    q = torch.from_numpy(rng.standard_normal((S, H, Dh),
                                             dtype=np.float32)).to(dev)
    kc, vc = (torch.randn((L, S, T, H, Dh), device=dev,
                          generator=torch.Generator(dev).manual_seed(
                              SEED + 4 + j)) for j in range(2))
    pos = torch.from_numpy(pick.astype(np.int32)).to(dev)
    scale = Dh ** -0.5
    keep = (torch.arange(T, device=dev)[None, :]
            <= pos.long()[:, None])[:, None, None, :]       # [S,1,1,T]
    q4 = q[:, :, None, :]
    F = torch.nn.functional

    def kern(i):
        return da.decode_attend(q, kc[i % L], vc[i % L], pos, scale)

    def plain(i):
        return da.decode_attend_plain(q, kc[i % L], vc[i % L], pos, scale)

    def library(i):
        return F.scaled_dot_product_attention(
            q4, kc[i % L].permute(0, 2, 1, 3), vc[i % L].permute(0, 2, 1, 3),
            attn_mask=keep, scale=scale)

    lib_err = float((library(0)[:, :, 0] - kern(0)).abs().max())
    # call counts keep every launch inside the stream's queue (~1000
    # launches) while the sleep kernel holds it; plain launches ~18
    k_ms = device_ms(torch, kern, 500)
    p_ms = device_ms(torch, plain, 40)
    l_ms = device_ms(torch, library, 200)
    k2_ms = device_ms(torch, kern, 500)
    nbytes = 2 * n_rows * H * Dh * 4 + 2 * S * H * Dh * 4 + S * 4
    flops = 4 * n_rows * H * Dh
    bound_ms, bound_by = _bound(nbytes, flops)
    log(f"[times] decode_attend S={S} T={T} H={H} Dh={Dh} "
        f"attended_rows={n_rows} (median step of {len(steps)}), "
        f"{L} cache copies cycled (L2 {l2} B): "
        f"kernel_ms={k_ms:.6f} (repeat {k2_ms:.6f}) "
        f"bound_us={bound_ms * 1e3:.3f} ({bound_by}: {nbytes} B, "
        f"{flops} flop) plain_ms={p_ms:.6f} library_ms(sdpa)={l_ms:.6f} "
        f"sdpa_vs_kernel_max_abs={lib_err:.3e}")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": l_ms}


def _l2_copies(torch, dev, nbytes):
    """How many copies of `nbytes` of inputs together exceed four times
    the L2 cache, so that cycling through them reads from HBM."""
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    return -(-4 * l2 // nbytes), l2


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def phase_times_quant(torch, qt, cfg, dev):
    """Quantize kernel and plain times at the main path's shape: one
    layer's new K (or V) rows of all 32 slots, 32 x 8 x 64 fp32 in
    blocks of 64. The timed calls cycle through input copies that
    together exceed four times the L2 cache."""
    S, H = 32, cfg.n_head
    Dh = cfg.d_model // H
    n, bs = S * H * Dh, Dh
    L, l2 = _l2_copies(torch, dev, n * 4)
    x = torch.randn((L, n), device=dev,
                    generator=torch.Generator(dev).manual_seed(SEED + 10))

    def kern(i):
        return qt.quantize_int8_blockwise(x[i % L], bs)

    def plain(i):
        return qt.quantize_int8_blockwise_plain(x[i % L], bs)

    k_ms = device_ms(torch, kern, 500)
    p_ms = device_ms(torch, plain, 60)      # ~10 launches a call
    k2_ms = device_ms(torch, kern, 500)
    nbytes = n * 4 + n + (n // bs) * 4
    ops = 5 * n             # abs, max, divide, round, clip per element
    bound_ms, bound_by = _bound(nbytes, ops)
    log(f"[times] quantize_int8_blockwise n={n} block_size={bs} "
        f"({L} input copies cycled, L2 {l2} B): kernel_ms={k_ms:.6f} "
        f"(repeat {k2_ms:.6f}) bound_us={bound_ms * 1e3:.4f} "
        f"({bound_by}: {nbytes} B, {ops} ops) plain_ms={p_ms:.6f} "
        f"library_ms=none (no single PyTorch call quantizes)")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def phase_times_dequant(torch, da, steps, cfg, dev):
    """int8 attention kernel and plain times at the main path's shape
    (S=32, T=256, H=8, Dh=64, one scale per head row) on the int8
    serving run's median decode step. The timed calls cycle through
    cache copies whose attended codes and scales together exceed four
    times the L2 cache. For information only, dequantizing both caches
    and calling scaled_dot_product_attention (several calls: cast and
    multiply for K and for V, then sdpa) is timed too."""
    S, T, H = 32, 256, cfg.n_head
    Dh = cfg.d_model // H
    nb = 1
    pick = median_step(steps, T)
    n_rows = int(np.minimum(pick + 1, T).sum())
    L, l2 = _l2_copies(torch, dev, 2 * n_rows * H * (Dh + 4 * nb))
    gen = torch.Generator(dev).manual_seed(SEED + 11)
    kq, vq = (torch.randint(-127, 128, (L, S, T, H, Dh), device=dev,
                            dtype=torch.int8, generator=gen)
              for _ in range(2))
    ks, vs = (0.005 + 0.015 * torch.rand((L, S, T, H, nb), device=dev,
                                         generator=gen)
              for _ in range(2))
    q = torch.randn((S, H, Dh), device=dev, generator=gen)
    pos = torch.from_numpy(pick.astype(np.int32)).to(dev)
    scale = Dh ** -0.5
    keep = (torch.arange(T, device=dev)[None, :]
            <= pos.long()[:, None])[:, None, None, :]       # [S,1,1,T]
    F = torch.nn.functional

    def kern(i):
        j = i % L
        return da.dequant_attend(q, kq[j], ks[j], vq[j], vs[j], pos, scale)

    def plain(i):
        j = i % L
        return da.dequant_attend_plain(q, kq[j], ks[j], vq[j], vs[j], pos,
                                       scale)

    def dequant_sdpa(i):
        j = i % L
        k = kq[j].float() * ks[j]           # nb = 1: one scale per row
        v = vq[j].float() * vs[j]
        return F.scaled_dot_product_attention(
            q[:, :, None, :], k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
            attn_mask=keep, scale=scale)[:, :, 0]

    two_err = float((dequant_sdpa(0) - kern(0)).abs().max())
    k_ms = device_ms(torch, kern, 500)
    p_ms = device_ms(torch, plain, 40)
    d_ms = device_ms(torch, dequant_sdpa, 150)
    k2_ms = device_ms(torch, kern, 500)
    nbytes = (2 * n_rows * H * Dh + 2 * n_rows * H * nb * 4
              + 2 * S * H * Dh * 4 + S * 4)
    ops = 6 * n_rows * H * Dh   # per element of k and v: multiply, fma
    bound_ms, bound_by = _bound(nbytes, ops)
    log(f"[times] dequant_attend S={S} T={T} H={H} Dh={Dh} nb={nb} "
        f"attended_rows={n_rows} (median step of {len(steps)}), "
        f"{L} cache copies cycled (L2 {l2} B): kernel_ms={k_ms:.6f} "
        f"(repeat {k2_ms:.6f}) bound_us={bound_ms * 1e3:.3f} "
        f"({bound_by}: {nbytes} B, {ops} flop) plain_ms={p_ms:.6f} "
        f"library_ms=none; for information, dequantize K and V + sdpa "
        f"(five calls) ms={d_ms:.6f}, its max_abs vs kernel="
        f"{two_err:.3e}")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def build_program(tfm, fw, unique_name, cfg, maxlen):
    """Transformer inference program built with the port's layers, in
    fresh programs under a fresh name guard: (main, startup, logits)."""
    main, startup = fw.Program(), fw.Program()
    with fw.program_guard(main, startup), unique_name.guard():
        _feeds, logits = tfm.build_infer_program(cfg, maxlen=maxlen)
    return main, startup, logits


def program_sources(cfg, n, T, seed):
    """n source rows padded to T, lengths from 8 to T."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, T + 1, n)
    lens[0] = T
    src = np.zeros((n, T), np.int64)
    for r, m in enumerate(lens):
        src[r, :m] = rng.integers(2, cfg.src_vocab, m)
    return src, lens.astype(np.int64)


def phase_program(torch, kern, tfm, core, params, cfg, dev):
    """Transformer-base inference through the Fluid Program and the
    Executor on the card: build_infer_program(maxlen=128) with the
    port's layers, run_startup (every parameter on the card in its
    declared shape and dtype), the shared weights loaded with
    scope_from_numpy, then greedy_decode(fetch_argmax=True) of 16 source
    sentences, 127 Executor.runs. Every launch count is set to 0 just
    before the decode and read just after: each run must launch the
    flash kernel 3 times a layer (18 at base) and the LayerNorm kernel 5
    times a layer (30), once for each such op of the program, and no
    other kernel."""
    T, B = 128, 16
    main, startup, logits = build_program(tfm, core.framework,
                                          core.unique_name, cfg, T)
    exe = core.Executor(core.CUDAPlace(0))
    check(exe.device.type == "cuda", f"executor on {exe.device}")
    fresh = core.Scope()
    t = time.perf_counter()
    exe.run_startup(startup, scope=fresh)
    torch.cuda.synchronize()
    t_start = time.perf_counter() - t
    n_params = 0
    for var in main.all_parameters():
        got = fresh.get(var.name)
        check(got is not None and got.device.type == "cuda"
              and tuple(got.shape) == var.shape
              and core.convert_dtype(got.dtype) == var.dtype,
              f"startup made {var.name} wrongly: "
              f"{None if got is None else (got.device, tuple(got.shape), got.dtype)}"
              f" for {var.shape} {var.dtype}")
        n_params += got.numel()
    scope = core.scope_from_numpy(params, dev)
    src, lens = program_sources(cfg, B, T, SEED + 14)
    runs, spent = [], [0.0]
    inner = exe.run

    def run(*a, **kw):
        t0 = time.perf_counter()
        out = inner(*a, **kw)       # ends in the fetch's readback
        spent[0] += time.perf_counter() - t0
        runs.append(1)
        return out
    exe.run = run
    for name in kern.LAUNCHES:
        kern.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    with core.scope_guard(scope):
        ids = tfm.greedy_decode(exe, main, logits, src, lens,
                                fetch_argmax=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    exe.run = inner
    n = len(runs)
    per_run = {"flash_attention": 3 * cfg.n_layer,
               "layer_norm": 5 * cfg.n_layer}
    census = {k: sum(op.type == k for op in main.global_block().ops)
              for k in per_run}
    check(census == per_run, f"op census {census} != {per_run}")
    want = {k: 0 for k in launches}
    want.update((k, c * n) for k, c in per_run.items())
    gen = ids[:, 1:]
    tokens = gen.size
    distinct = len(np.unique(gen))
    log(f"[program] Transformer-base d_model={cfg.d_model} d_inner="
        f"{cfg.d_inner} heads={cfg.n_head} layers={cfg.n_layer} vocab="
        f"{cfg.trg_vocab}, build_infer_program(maxlen={T}): "
        f"{len(main.global_block().ops)} ops ({len(main.all_parameters())} "
        f"parameters, {n_params} weights), run_startup on the card "
        f"{t_start:.3f} s; greedy_decode B={B} source lengths "
        f"{int(lens.min())}-{int(lens.max())}: runs={n} tokens={tokens} "
        f"distinct_tokens={distinct} wall_s={wall:.3f} tokens_per_s="
        f"{tokens / wall:.1f} host_ms_per_run={spent[0] / n * 1e3:.3f} "
        f"LAUNCHES={launches} (required {want}: {per_run} a run)")
    check(n == T - 1 and ids.shape == (B, T), f"{n} runs, ids {ids.shape}")
    check(int(gen.min()) >= 0 and int(gen.max()) < cfg.trg_vocab,
          "token id range")
    check(distinct > 1, "every generated token is the same")
    check(launches == want, f"LAUNCHES {launches} != {want}")
    return launches, exe, main, logits, scope, src, lens, ids


def phase_program_card_vs_cpu(core, main, logits, params, src, lens, ids,
                              card_exe, card_scope):
    """One teacher-forced Executor.run of the same program on the card
    and on the CPU (plain versions) from the same weights, on 4 of the
    sentences with the card's greedy tokens as targets: logits within
    PROGRAM_LOGIT_ATOL, and an argmax token may differ only where the
    CPU logits' top-two margin is below it."""
    import torch
    rows = [0, 3, 7, 12]
    trg_len = np.array([128, 100, 64, 9], np.int64)
    feed = {"src": src[rows], "src_len": lens[rows], "trg": ids[rows],
            "trg_len": trg_len}
    card = card_exe.run(main, feed=feed, fetch_list=[logits],
                        scope=card_scope, is_test=True)[0]
    cpu_exe = core.Executor(core.CPUPlace())
    cpu_scope = core.scope_from_numpy(params, torch.device("cpu"))
    t = time.perf_counter()
    cpu = cpu_exe.run(main, feed=feed, fetch_list=[logits],
                      scope=cpu_scope, is_test=True)[0]
    t_cpu = time.perf_counter() - t
    live = np.arange(128)[None, :] < trg_len[:, None]      # [4, 128]
    diff = float(np.abs(card - cpu)[live].max())
    top2 = np.sort(cpu, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    differ = (card.argmax(-1) != cpu.argmax(-1)) & live
    log(f"[program card-vs-cpu] 4 sentences x 128 positions, teacher-"
        f"forced, trg_len={trg_len.tolist()}: max |logit diff| over live "
        f"positions={diff:.3e} (bound {PROGRAM_LOGIT_ATOL:.0e}, max "
        f"|logit|={float(np.abs(cpu).max()):.2f}); argmax differing="
        f"{int(differ.sum())} of {int(live.sum())} ({int((margin[live] < PROGRAM_LOGIT_ATOL).sum())}"
        f" under the margin); CPU run {t_cpu:.2f} s")
    check(diff <= PROGRAM_LOGIT_ATOL, f"program logits differ by {diff}")
    check(bool(np.all(margin[differ] < PROGRAM_LOGIT_ATOL)),
          "a token differs above the top-two margin")


def phase_program_profile(torch, exe, main, logits, scope, src, lens,
                          ids):
    """Where one Executor.run's time goes (the greedy run's step at
    t = 64): host wall per run, device busy time per run from
    torch.profiler, idle share in the profiled window, and the kernels
    that take it (the port's own: `flash_fwd_kernel` and
    `layer_norm_fwd_kernel`)."""
    B = src.shape[0]
    feed = {"src": src, "src_len": lens, "trg": ids,
            "trg_len": np.full((B,), 64, np.int64)}
    fetch = [main._greedy_argmax_var]

    def once():
        return exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                       is_test=True)
    wall_ms, prof_ms, by_name = profile_window(torch, once, n=10, warm=3)
    busy_us = sum(by_name.values())
    share = idle_share(busy_us, prof_ms, "program run")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    ours = "; ".join(
        f"{kname} {us:.1f} us/run ({us / busy_us:.3f} of device time)"
        for kname, us in (
            (kname, sum(v for k, v in by_name.items() if kname in k))
            for kname in ("flash_fwd_kernel", "layer_norm_fwd_kernel")))
    log(f"[profile] program run (B={B}, T=128, argmax fetch): host wall "
        f"{wall_ms:.3f} ms/run unprofiled, {prof_ms:.3f} ms/run profiled; "
        f"device busy {busy_us / 1e3:.3f} ms/run -> idle share "
        f"{share:.3f} (profiled window; "
        f"{1 - busy_us / 1e3 / wall_ms:.3f} against the unprofiled wall); "
        f"{ours}; top device ops us/run: "
        + "; ".join(f"{k[:60]}={v:.1f}" for k, v in top))


def phase_times_layer_norm(torch, ln, dev):
    """LayerNorm kernel, plain and library (F.layer_norm) times at the
    Program path's shape, x [16, 128, 512] fp32. The timed calls cycle
    through input copies that together exceed four times the L2
    cache."""
    shape, C = (16, 128, 512), 512
    n = 16 * 128 * 512
    L, l2 = _l2_copies(torch, dev, n * 4 * 2)
    gen = torch.Generator(dev).manual_seed(SEED + 15)
    x = torch.randn((L,) + shape, device=dev, generator=gen)
    g = 1 + 0.2 * torch.randn(C, device=dev, generator=gen)
    b = 0.1 * torch.randn(C, device=dev, generator=gen)
    F = torch.nn.functional

    def kern(i):
        return ln.layer_norm(x[i % L], g, b, 1e-5)

    def plain(i):
        return ln.layer_norm_plain(x[i % L], g, b, 1e-5)

    def library(i):
        return F.layer_norm(x[i % L], (C,), g, b, 1e-5)

    lib_err = float((library(0) - kern(0)[0]).abs().max())
    k_ms = device_ms(torch, kern, 500)
    p_ms = device_ms(torch, plain, 60)
    l_ms = device_ms(torch, library, 500)
    k2_ms = device_ms(torch, kern, 500)
    rows = n // C
    nbytes = 2 * n * 4 + 2 * C * 4 + 2 * rows * 4
    ops = 8 * n
    bound_ms, bound_by = _bound(nbytes, ops)
    log(f"[times] layer_norm x={list(shape)} fp32 ({L} input copies "
        f"cycled, L2 {l2} B): kernel_ms={k_ms:.6f} (repeat {k2_ms:.6f}) "
        f"bound_us={bound_ms * 1e3:.3f} ({bound_by}: {nbytes} B, {ops} "
        f"ops) plain_ms={p_ms:.6f} library_ms(F.layer_norm)={l_ms:.6f} "
        f"library_vs_kernel_max_abs={lib_err:.3e}")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": l_ms}


def phase_times_flash(torch, fa, dev):
    """Flash kernel, plain and library (scaled_dot_product_attention,
    the bias as attn_mask) times at the Program path's shape: B 16, H 8,
    T = S = 128, D 64, layout bthd, with the pad bias; non-causal (the
    encoder and cross attention, 12 of the 18 launches a run) for the
    kernels line, and causal (the decoder's self attention) beside it.
    Every key is live (source lengths 128), which is what the bound
    counts. The timed calls cycle through input copies that together
    exceed four times the L2 cache."""
    B, H, T, S, D = 16, 8, 128, 128, 64
    per = (2 * B * S * H * D + B * T * H * D) * 4
    L, l2 = _l2_copies(torch, dev, per)
    gen = torch.Generator(dev).manual_seed(SEED + 16)
    q, k, v = (torch.randn((L, B, n, H, D), device=dev, generator=gen)
               for n in (T, S, S))
    bias = torch.zeros((B, 1, 1, S), device=dev)
    scale = D ** -0.5
    F = torch.nn.functional
    out = {}
    for causal in (False, True):
        def kern(i, c=causal):
            j = i % L
            return fa.flash_attention(q[j], k[j], v[j], bias, c, scale, 0,
                                      "bthd")

        def plain(i, c=causal):
            j = i % L
            return fa.flash_attention_plain(q[j], k[j], v[j], bias, c,
                                            scale, 0, "bthd")

        def library(i, c=causal):
            j = i % L
            mask = bias
            if c:
                mask = bias + torch.zeros((T, S), device=dev).masked_fill(
                    ~torch.ones((T, S), dtype=torch.bool,
                                device=dev).tril(), float("-inf"))
            return F.scaled_dot_product_attention(
                q[j].transpose(1, 2), k[j].transpose(1, 2),
                v[j].transpose(1, 2), attn_mask=mask, scale=scale)

        lib_err = float((library(0).transpose(1, 2) - kern(0)[0]).abs().max())
        k_ms = device_ms(torch, kern, 300)
        p_ms = device_ms(torch, plain, 60)
        l_ms = device_ms(torch, library, 300)
        k2_ms = device_ms(torch, kern, 300)
        pairs = T * (T + 1) // 2 if causal else T * S
        nbytes = (2 * B * S * H * D + 2 * B * T * H * D) * 4 + B * S * 4 \
            + B * H * T * 4
        flops = 4 * B * H * pairs * D
        bound_ms, bound_by = _bound(nbytes, flops)
        log(f"[times] flash_attention B={B} H={H} T={T} S={S} D={D} bthd "
            f"pad bias causal={causal} ({L} input copies cycled, L2 {l2} "
            f"B): kernel_ms={k_ms:.6f} (repeat {k2_ms:.6f}) bound_us="
            f"{bound_ms * 1e3:.3f} ({bound_by}: {nbytes} B, {flops} flop) "
            f"plain_ms={p_ms:.6f} library_ms(sdpa)={l_ms:.6f} "
            f"sdpa_vs_kernel_max_abs={lib_err:.3e}")
        out[causal] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": l_ms}
    return out[False]


def _allclose_err(torch, got, want, tol):
    """(max |got - want|, whether |got - want| <= tol + tol |want|
    everywhere)."""
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), bool((diff <= tol + tol * want.float().abs())
                                   .all())


def _flash_bwd_inputs(torch, fa, rng, dev, B, H, T, S, D, layout, bias_kind,
                      causal, off):
    """q, k, v, a per-key pad bias (or None), the forward's out and lse
    (plain version), cotangents dout and dlse that are zero on rows with
    no key, and delta = rowsum(dout * out) - dlse, as the backward's
    wrapper computes it."""
    def mk(n, d=D):
        shp = (B, H, n, d) if layout == "bhtd" else (B, n, H, d)
        return torch.from_numpy(rng.standard_normal(
            shp, dtype=np.float32)).to(dev)
    q, k, v, dout = mk(T), mk(S), mk(S), mk(T)
    bias = None
    if bias_kind is not None:
        lens = rng.integers(1, S + 1, B)
        lens[0] = S
        keep = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
        pad = keep * 1e9 - 1e9
        bias = {"b11s": pad[:, None, None, :], "bs": pad, "1s": pad[:1],
                "111s": pad[:1, None, None, :]}[bias_kind]
        bias = torch.from_numpy(np.ascontiguousarray(bias)).to(dev)
    out, lse = fa.flash_attention_plain(q, k, v, bias, causal, D ** -0.5,
                                        off, layout)
    live = torch.from_numpy(
        np.arange(T) + (S - T + off if causal else S) >= 0).to(dev)
    lv = live[None, None, :, None] if layout == "bhtd" \
        else live[None, :, None, None]
    dout = dout * lv
    dlse = torch.from_numpy(rng.standard_normal(
        (B, H, T), dtype=np.float32)).to(dev) * live
    o, do = (x if layout == "bhtd" else x.transpose(1, 2)
             for x in (out, dout))
    delta = (do * o).sum(-1) - dlse
    return q, k, v, bias, dout, lse, delta


def phase_flash_bwd_vs_plain(torch, fa, dev):
    """The dq and dk/dv kernels against their plain versions on the
    card, as allclose at FLASH_GRAD_TOL: at the training shape (B 64,
    H 8, T = S = 128, D 64, bthd, pad bias, causal and not) and on a
    dozen more cases: T != S, lengths 37 and 50 that are not tile
    multiples, D 32 and 128, the bhtd layout, every bias shape, causal
    offsets -1 and -5, all with an lse cotangent folded into delta; the
    bias-gradient rows on every case with a bias. Each kernel runs
    twice: the results must be identical (no atomics)."""
    rng = np.random.default_rng(SEED + 20)
    worst = {"flash_attention_dq": 0.0, "flash_attention_dkv": 0.0}
    cases = [(64, 8, 128, 128, 64, "bthd", "b11s", c, 0)
             for c in (False, True)]
    cases += [(4, 8, 128, 96, 64, "bthd", "b11s", False, 0),
              (4, 8, 96, 128, 64, "bthd", "b11s", True, 0),
              (4, 8, 50, 37, 64, "bthd", "bs", False, 0),
              (4, 8, 37, 50, 64, "bthd", "b11s", True, 0),
              (4, 8, 128, 128, 32, "bthd", "b11s", True, 0),
              (4, 8, 128, 128, 128, "bhtd", "1s", False, 0),
              (4, 8, 96, 128, 128, "bhtd", "111s", True, 0),
              (4, 8, 128, 128, 64, "bthd", "b11s", True, -1),
              (2, 4, 50, 37, 64, "bhtd", None, True, -5),
              (3, 2, 37, 37, 32, "bthd", None, False, 0),
              (2, 3, 200, 64, 64, "bthd", "bs", True, 0)]
    for B, H, T, S, D, layout, bias_kind, causal, off in cases:
        q, k, v, bias, dout, lse, delta = _flash_bwd_inputs(
            torch, fa, rng, dev, B, H, T, S, D, layout, bias_kind, causal,
            off)
        args = (q, k, v, bias, dout, lse, delta, causal, D ** -0.5, off,
                layout)
        dq = fa.flash_attention_dq(*args)
        dq2 = fa.flash_attention_dq(*args)
        dk, dv, db = fa.flash_attention_dkv(*args, bias_grad=True)
        dk2, dv2, db2 = fa.flash_attention_dkv(*args, bias_grad=True)
        torch.cuda.synchronize()
        pdq = fa.flash_attention_dq_plain(*args)
        pdk, pdv, pdb = fa.flash_attention_dkv_plain(*args, bias_grad=True)
        torch.cuda.synchronize()
        check(torch.equal(dq, dq2) and torch.equal(dk, dk2)
              and torch.equal(dv, dv2)
              and (db is None or torch.equal(db, db2)),
              "flash backward kernels are not deterministic")
        check(all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv)),
              "flash backward not finite")
        e_q, ok_q = _allclose_err(torch, dq, pdq, FLASH_GRAD_TOL)
        e_k, ok_k = _allclose_err(torch, dk, pdk, FLASH_GRAD_TOL)
        e_v, ok_v = _allclose_err(torch, dv, pdv, FLASH_GRAD_TOL)
        e_b, ok_b = (0.0, True) if db is None else \
            _allclose_err(torch, db, pdb, FLASH_GRAD_TOL)
        log(f"[kernel] flash backward B={B} H={H} T={T} S={S} D={D} "
            f"{layout} bias={bias_kind} causal={causal} offset={off}: max "
            f"|err| dq={e_q:.3e} dk={e_k:.3e} dv={e_v:.3e} db_rows="
            f"{e_b:.3e} (allclose rtol=atol={FLASH_GRAD_TOL:.0e}; max "
            f"|dq|={float(pdq.abs().max()):.2f} |dk|="
            f"{float(pdk.abs().max()):.2f}); repeat identical")
        check(ok_q, f"flash dq disagrees: {e_q}")
        check(ok_k and ok_v and ok_b,
              f"flash dk/dv/db disagree: {e_k} {e_v} {e_b}")
        worst["flash_attention_dq"] = max(worst["flash_attention_dq"], e_q)
        worst["flash_attention_dkv"] = max(worst["flash_attention_dkv"],
                                           e_k, e_v, e_b)
    return worst


def phase_layer_norm_bwd_vs_plain(torch, ln, dev):
    """The LayerNorm backward kernel against its plain version on the
    card, as allclose at LN_GRAD_TOL for dx, dscale and dbias: at the
    training shape [64, 128, 512], odd row counts, a single row, and
    every width class of the kernel (C 32, 64, 96, 128, 256, 512, 1024;
    eight warps a row: 1536, 2048, 4096, 8192). It runs twice: the
    results must be identical (no atomics)."""
    rng = np.random.default_rng(SEED + 21)
    worst = 0.0
    for shape in ((64, 128, 512), (1001, 512), (300, 2048), (37, 1536),
                  (40, 8192), (7, 96), (1, 512), (9, 32), (3, 64),
                  (2, 8, 128), (513, 256), (64, 1024), (100, 4096)):
        C = shape[-1]
        x = torch.from_numpy((rng.standard_normal(shape, dtype=np.float32)
                              * 3.0 + 0.5).astype(np.float32)).to(dev)
        dy = torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev)
        g = torch.from_numpy((1 + 0.2 * rng.standard_normal(
            C, dtype=np.float32)).astype(np.float32)).to(dev)
        got = ln.layer_norm_bwd(dy, x, g, 1e-5)
        again = ln.layer_norm_bwd(dy, x, g, 1e-5)
        torch.cuda.synchronize()
        want = ln.layer_norm_bwd_plain(dy, x, g, 1e-5)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              "layer_norm backward kernel is not deterministic")
        errs = [_allclose_err(torch, a, b, LN_GRAD_TOL)
                for a, b in zip(got, want)]
        rows = x.numel() // C
        log(f"[kernel] layer_norm_bwd x={list(shape)} ({rows} rows): max "
            f"|err| "
            f"dx={errs[0][0]:.3e} dscale={errs[1][0]:.3e} dbias="
            f"{errs[2][0]:.3e} (allclose rtol=atol={LN_GRAD_TOL:.0e}; max "
            f"|dscale|={float(want[1].abs().max()):.2f}); repeat identical")
        check(all(ok for _e, ok in errs),
              f"layer_norm backward disagrees: {[e for e, _ in errs]}")
        worst = max(worst, *(e for e, _ in errs))
    return worst


def build_train_program(tfm, fw, unique_name, optimizer, cfg, maxlen):
    """The training program (build_program, then Adam(TRAIN_LR)
    .minimize) built with the port's layers in fresh programs under a
    fresh name guard: (main, startup, avg_cost)."""
    main, startup = fw.Program(), fw.Program()
    with fw.program_guard(main, startup), unique_name.guard():
        _feeds, avg_cost, _tok = tfm.build_program(cfg, maxlen=maxlen)
        optimizer.Adam(TRAIN_LR).minimize(avg_cost)
    return main, startup, avg_cost


def copy_task_feed(cfg, B, T, seed):
    """bench.py:317-325's copy task: random source ids, the target is
    the source shifted by one token id, every sentence full length."""
    rng = np.random.RandomState(seed)
    src = rng.randint(3, cfg.src_vocab, (B, T)).astype(np.int64)
    trg = np.concatenate([np.zeros((B, 1), np.int64),
                          (src[:, :-1] + 1) % cfg.trg_vocab], axis=1)
    return {"src": src, "src_len": np.full(B, T, np.int64), "trg": trg,
            "trg_len": np.full(B, T, np.int64),
            "label": (src + 1) % cfg.trg_vocab}


def train_config(tfm, dropout):
    """bench.py:302-306's configuration with the given dropout."""
    return tfm.TransformerConfig(
        src_vocab=8000, trg_vocab=8000, max_len=TRAIN_T, d_model=512,
        d_inner=2048, n_head=8, n_layer=6, dropout=dropout, fused_qkv=True)


def phase_train(torch, kern, tfm, core, dev):
    """The Transformer-base training step on the card, fp32, Adam(1e-3),
    at bench.py's configuration (dropout 0.1, fused q/k/v) and batch
    (B, T) = (64, 128) on the copy task: run_startup on the card, one
    warm-up step, then 10 steps, each an Executor.run that fetches the
    loss. Every launch count is set to 0 just before the 10 steps and
    read just after: each step must launch the flash forward, dq and
    dk/dv kernels once per attention op (18 at base), the LayerNorm
    forward and backward kernels once per layer_norm op (30), and no
    other kernel. Every loss must be finite, and the last below the
    first."""
    cfg = train_config(tfm, dropout=0.1)
    B, T = TRAIN_B, TRAIN_T
    main, startup, avg_cost = build_train_program(
        tfm, core.framework, core.unique_name, core.optimizer, cfg, T)
    main.random_seed = startup.random_seed = SEED
    exe = core.Executor(core.CUDAPlace(0))
    scope = core.Scope()
    exe.run_startup(startup, scope=scope)
    feed = copy_task_feed(cfg, B, T, 0)
    census = {k: sum(op.type == k for op in main.global_block().ops)
              for k in ("flash_attention", "layer_norm", "adam")}
    per_step = {"flash_attention": 3 * cfg.n_layer,
                "flash_attention_dq": 3 * cfg.n_layer,
                "flash_attention_dkv": 3 * cfg.n_layer,
                "layer_norm": 5 * cfg.n_layer,
                "layer_norm_bwd": 5 * cfg.n_layer}
    check(census["flash_attention"] == per_step["flash_attention"]
          and census["layer_norm"] == per_step["layer_norm"]
          and census["adam"] == len(main.all_parameters()),
          f"training program census {census}")
    t = time.perf_counter()
    losses = [float(exe.run(main, feed=feed, fetch_list=[avg_cost],
                            scope=scope)[0])]
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t
    n = 10
    for name in kern.LAUNCHES:
        kern.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    for _ in range(n):
        losses.append(float(exe.run(main, feed=feed, fetch_list=[avg_cost],
                                    scope=scope)[0]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    want = {k: 0 for k in launches}
    want.update((k, c * n) for k, c in per_step.items())
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    log(f"[train] Transformer-base d_model={cfg.d_model} d_inner="
        f"{cfg.d_inner} heads={cfg.n_head} layers={cfg.n_layer} vocab="
        f"{cfg.trg_vocab} dropout={cfg.dropout} fused_qkv fp32, Adam("
        f"{TRAIN_LR}), B={B} T={T}: {len(main.global_block().ops)} ops "
        f"({census['adam']} adam, {len(main.all_parameters())} parameters, "
        f"{n_params} weights); warm-up step {t_first:.3f} s; {n} steps "
        f"wall_s={wall:.3f} trained_tokens_per_s={n * B * T / wall:.1f} "
        f"host_ms_per_step={wall / n * 1e3:.3f} LAUNCHES={launches} "
        f"(required {want}: {per_step} a step); losses (warm-up, then "
        f"steps 1-{n}): " + ", ".join(f"{x:.6f}" for x in losses))
    check(all(np.isfinite(losses)), f"a loss is not finite: {losses}")
    check(losses[-1] < losses[1], f"loss did not fall: {losses}")
    check(launches == want, f"LAUNCHES {launches} != {want}")
    return launches, exe, main, avg_cost, scope, feed


def phase_train_profile(torch, exe, main, avg_cost, scope, feed):
    """Where one training step's time goes: host wall per step over 3
    unprofiled steps (after 2 more), then torch.profiler over 3 steps:
    device busy time per step, idle share in the profiled window, and
    the device kernels that take it (the port's own:
    flash_fwd_kernel, flash_dq_kernel, flash_dkv_kernel,
    layer_norm_fwd_kernel, layer_norm_bwd_kernel and its reduce)."""

    def once():
        return exe.run(main, feed=feed, fetch_list=[avg_cost], scope=scope)
    wall_ms, prof_ms, by_name = profile_window(torch, once, n=3, warm=2)
    busy_us = sum(by_name.values())
    share = idle_share(busy_us, prof_ms, "training step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ours = "; ".join(
        f"{kname} {us:.1f} us/step ({us / busy_us:.3f} of device time)"
        for kname, us in (
            (kname, sum(v for k, v in by_name.items() if kname in k))
            for kname in ("flash_fwd_kernel", "flash_dq_kernel",
                          "flash_dkv_kernel", "layer_norm_fwd_kernel",
                          "layer_norm_bwd_kernel", "layer_norm_bwd_reduce")))
    gemm_us = sum(v for k, v in by_name.items()
                  if "gemm" in k or "splitKreduce" in k)
    log(f"[profile] training step (B={TRAIN_B}, T={TRAIN_T}): host wall "
        f"{wall_ms:.3f} ms/step unprofiled, {prof_ms:.3f} ms/step "
        f"profiled; device busy {busy_us / 1e3:.3f} ms/step -> idle share "
        f"{share:.3f} (profiled window; "
        f"{1 - busy_us / 1e3 / wall_ms:.3f} against the unprofiled wall); "
        f"GEMMs {gemm_us / 1e3:.3f} ms/step ({gemm_us / busy_us:.3f} of "
        f"device time); {ours}; top device ops us/step: "
        + "; ".join(f"{k[:60]}={v:.1f}" for k, v in top))


def _grad_parity(pnames, g_card, g_cpu):
    """Gradients of one step, tensor by tensor, at TRAIN_GRAD_RTOL /
    TRAIN_GRAD_FLOOR: (tensors with more than TRAIN_OUTLIER_SHARE of
    their elements outside, as [(name, outside, elements)], elements
    outside in all, the tensor with the largest share outside, the
    largest |diff| over its tensor's largest, and that tensor)."""
    top = max(float(np.abs(g).max()) for g in g_cpu)
    failed, outside, most, worst = [], 0, (0.0, "-"), (0.0, "-")
    for n, gc, gp in zip(pnames, g_card, g_cpu):
        d = np.abs(gc - gp)
        own = float(np.abs(gp).max())
        bad = int((d > TRAIN_GRAD_RTOL * own + TRAIN_GRAD_FLOOR * top).sum())
        outside += bad
        if bad / d.size > most[0]:
            most = (bad / d.size, n)
        if float(d.max()) > worst[0] * own:
            worst = (float(d.max()) / max(own, 1e-30), n)
        if bad > int(TRAIN_OUTLIER_SHARE * d.size):
            failed.append((n, bad, d.size))
    return failed, outside, most, worst


def _adam_parity(torch, registry, main, state, grads, new_card):
    """The card's Adam tail against the port's `adam` op run on the CPU
    from `state` and the card's gradients `grads` ({name: array}):
    (persistables outside TRAIN_ADAM_RTOL or not identical, largest
    parameter |diff| over lr, largest moment |diff| over its tensor's
    largest)."""
    cpu = torch.device("cpu")
    ctx = registry.KernelCtx(device=cpu)
    adam = registry.get_kernel("adam")
    failed, e_param, e_moment = [], 0.0, 0.0
    for op in main.global_block().ops:
        if op.type != "adam":
            continue
        ins = {k: [torch.from_numpy(grads[v[0]] if k == "Grad"
                                    else state[v[0]])]
               for k, v in op.inputs.items()}
        out = adam(ctx, ins, op.attrs)
        lr = float(state[op.inputs["LearningRate"][0]].reshape(-1)[0])
        for slot, (t,) in out.items():
            n = op.outputs[slot][0]
            want, got = t.numpy(), new_card[n]
            d = np.abs(got - want)
            if slot == "ParamOut":
                scale = lr
                e_param = max(e_param, float(d.max()) / lr)
            elif slot.startswith("Moment"):
                scale = float(np.abs(want).max())
                e_moment = max(e_moment,
                               float(d.max()) / max(scale, 1e-30))
            else:
                if not np.array_equal(got, want):
                    failed.append(n)
                continue
            if (d > TRAIN_ADAM_RTOL * (np.abs(want) + scale)).any():
                failed.append(n)
    return failed, e_param, e_moment


def phase_train_card_vs_cpu(torch, tfm, core):
    """The training step on the card against the port's CPU run (plain
    versions) at Transformer-base width, B 4, T 32, dropout 0, from one
    scope made by run_startup on the CPU (scope_to_numpy /
    scope_from_numpy), 3 steps of the copy task, each fetching the loss
    and every gradient. The CPU runs freely; the card runs each step
    from the CPU's state. The bounds are stated at TRAIN_LOSS_TOL."""
    cfg = train_config(tfm, dropout=0.0)
    B, T, steps = 4, 32, 3
    main, startup, avg_cost = build_train_program(
        tfm, core.framework, core.unique_name, core.optimizer, cfg, T)
    startup.random_seed = SEED + 22
    init_scope = core.Scope()
    core.Executor(core.CPUPlace()).run_startup(startup, scope=init_scope)
    names = [v.name for v in main.persistable_vars()]
    bop = [op for op in main.global_block().ops
           if op.type == "backward_macro"][0]
    pnames, gnames = bop.attrs["param_names"], bop.outputs["Grads"]
    fetch = [avg_cost] + gnames
    card, cpu = core.Executor(core.CUDAPlace(0)), core.Executor(
        core.CPUPlace())

    def step(exe, state, feed):
        scope = core.scope_from_numpy(state, exe.device)
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        return [np.asarray(o) for o in out], core.scope_to_numpy(scope,
                                                                 names)
    state = core.scope_to_numpy(init_scope, names)
    feed = copy_task_feed(cfg, B, T, 0)
    repeat = {}
    for side, exe in (("card", card), ("cpu", cpu)):
        (a, sa), (b, sb) = step(exe, state, feed), step(exe, state, feed)
        repeat[side] = all(np.array_equal(x, y) for x, y in zip(a, b)) \
            and all(np.array_equal(sa[n], sb[n]) for n in names)
    losses, lines, failed = {"card": [], "cpu": []}, [], []
    t_cpu = 0.0
    for s in range(steps):
        feed = copy_task_feed(cfg, B, T, s)
        got, new_card = step(card, state, feed)
        t = time.perf_counter()
        want, new_cpu = step(cpu, state, feed)
        t_cpu += time.perf_counter() - t
        losses["card"].append(float(got[0]))
        losses["cpu"].append(float(want[0]))
        g_bad, g_out, g_most, g_worst = _grad_parity(pnames, got[1:],
                                                     want[1:])
        a_bad, a_param, a_moment = _adam_parity(
            torch, core.registry, main, state, dict(zip(gnames, got[1:])),
            new_card)
        p_diff = max(float(np.abs(new_card[n] - new_cpu[n]).max())
                     for n in pnames)
        failed += [f"step {s + 1} gradient {n}: {k} of {m} outside"
                   for n, k, m in g_bad]
        failed += [f"step {s + 1} Adam tail {n}" for n in a_bad]
        lines.append(
            f"step {s + 1}: gradients outside {g_out} of all elements, "
            f"largest share {g_most[0]:.3e} in {g_most[1]}, largest |diff| "
            f"/ own max {g_worst[0]:.3e} in {g_worst[1]}; Adam tail against "
            f"the CPU's adam op on the card's gradients: params |diff| / lr "
            f"{a_param:.3e}, moments |diff| / own max {a_moment:.3e}, "
            f"{len(a_bad)} persistables outside; parameters against the "
            f"CPU run's max |diff| {p_diff:.3e}")
        state = new_cpu
    e_loss = max(abs(a - b) for a, b in zip(losses["card"], losses["cpu"]))
    log(f"[train card-vs-cpu] Transformer-base vocab={cfg.trg_vocab} B={B} "
        f"T={T} dropout 0, {steps} steps from one scope, the card from the "
        f"CPU's state at every step: losses cpu "
        + ", ".join(f"{x:.6f}" for x in losses["cpu"]) + ", card "
        + ", ".join(f"{x:.6f}" for x in losses["card"])
        + f"; max |loss diff|={e_loss:.3e} (bound {TRAIN_LOSS_TOL:.0e}); "
        f"step 1 repeats bit for bit: card {repeat['card']}, cpu "
        f"{repeat['cpu']}; bounds: gradient |diff| <= {TRAIN_GRAD_RTOL:.0e}"
        f" x own max + 2^-23 x the step's max, at most "
        f"{TRAIN_OUTLIER_SHARE:.0e} of a tensor outside; Adam tail within "
        f"{TRAIN_ADAM_RTOL:.0e} x (|value| + lr or own max), beta powers "
        f"and lr identical | " + " | ".join(lines)
        + f"; CPU {t_cpu:.2f} s")
    check(e_loss <= TRAIN_LOSS_TOL, f"training losses differ by {e_loss}")
    check(repeat["card"] and repeat["cpu"],
          f"a training step does not repeat bit for bit: {repeat}")
    check(not failed, f"training step card vs CPU: {failed[:10]}")


def phase_times_flash_bwd(torch, fa, dev):
    """dq and dk/dv kernel, plain and library times at the training
    shape: B 64, H 8, T = S = 128, D 64, layout bthd, pad bias of full
    lengths, non-causal (the encoder and cross attention, 12 of the 18
    attention ops; causal is logged beside it). The library is the
    backward of scaled_dot_product_attention (the bias as attn_mask)
    through autograd, timed alone: one call that computes dq, dk and dv
    together, so both kernels' lines carry it. The timed calls cycle
    through input copies that together exceed four times the L2
    cache."""
    B, H, T, S, D = TRAIN_B, 8, TRAIN_T, TRAIN_T, 64
    elems = B * T * H * D
    per = 4 * (4 * elems + 2 * B * H * T + B * S)
    L, l2 = _l2_copies(torch, dev, per)
    gen = torch.Generator(dev).manual_seed(SEED + 23)
    q, k, v, dout = (torch.randn((L, B, T, H, D), device=dev, generator=gen)
                     for _ in range(4))
    bias = torch.zeros((B, 1, 1, S), device=dev)
    scale = D ** -0.5
    F = torch.nn.functional
    out = {}
    for causal in (False, True):
        stats = []
        for j in range(L):
            o, lse = fa.flash_attention_plain(q[j], k[j], v[j], bias, causal,
                                              scale, 0, "bthd")
            stats.append((lse, (dout[j] * o).sum(-1).transpose(1, 2)
                          .contiguous()))

        def args(i, c=causal):
            j = i % L
            return (q[j], k[j], v[j], bias, dout[j], stats[j][0],
                    stats[j][1], c, scale, 0, "bthd")

        leaves = [[x[j].transpose(1, 2).detach().requires_grad_(True)
                   for x in (q, k, v)] for j in range(L)]
        mask = bias
        if causal:
            mask = bias + torch.zeros((T, S), device=dev).masked_fill(
                ~torch.ones((T, S), dtype=torch.bool, device=dev).tril(),
                float("-inf"))
        with torch.enable_grad():
            outs = [F.scaled_dot_product_attention(*lv, attn_mask=mask,
                                                   scale=scale)
                    for lv in leaves]

        def library(i):
            j = i % L
            return torch.autograd.grad(outs[j], leaves[j],
                                       dout[j].transpose(1, 2),
                                       retain_graph=True)

        ldq, ldk, ldv = library(0)
        kdq = fa.flash_attention_dq(*args(0))
        kdk, kdv, _db = fa.flash_attention_dkv(*args(0))
        lib_err = max(float((ldq.transpose(1, 2) - kdq).abs().max()),
                      float((ldk.transpose(1, 2) - kdk).abs().max()),
                      float((ldv.transpose(1, 2) - kdv).abs().max()))
        kq_ms = device_ms(torch, lambda i: fa.flash_attention_dq(*args(i)),
                          200)
        kkv_ms = device_ms(torch,
                           lambda i: fa.flash_attention_dkv(*args(i)), 200)
        pq_ms = device_ms(
            torch, lambda i: fa.flash_attention_dq_plain(*args(i)), 30)
        pkv_ms = device_ms(
            torch, lambda i: fa.flash_attention_dkv_plain(*args(i)), 30)
        l_ms = device_ms(torch, library, 100)
        kq2_ms = device_ms(torch, lambda i: fa.flash_attention_dq(*args(i)),
                           200)
        kkv2_ms = device_ms(torch,
                            lambda i: fa.flash_attention_dkv(*args(i)), 200)
        pairs = T * (T + 1) // 2 if causal else T * S
        stats_b = 2 * B * H * T * 4 + B * S * 4
        res = {}
        for name, ms, rep, p_ms, n_prod, n_out in (
                ("flash_attention_dq", kq_ms, kq2_ms, pq_ms, 3, 1),
                ("flash_attention_dkv", kkv_ms, kkv2_ms, pkv_ms, 4, 2)):
            flops = 2 * n_prod * B * H * pairs * D
            nbytes = (4 + n_out) * elems * 4 + stats_b
            bound_ms, bound_by = _bound(nbytes, flops)
            log(f"[times] {name} B={B} H={H} T={T} S={S} D={D} bthd pad "
                f"bias causal={causal} ({L} input copies cycled, L2 {l2} "
                f"B): kernel_ms={ms:.6f} (repeat {rep:.6f}) bound_us="
                f"{bound_ms * 1e3:.3f} ({bound_by}: {nbytes} B, {flops} "
                f"flop) plain_ms={p_ms:.6f} library_ms(sdpa backward, dq "
                f"dk dv together)={l_ms:.6f} sdpa_vs_kernels_max_abs="
                f"{lib_err:.3e}")
            res[name] = {"ms": ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": l_ms}
        out[causal] = res
        del outs, leaves, stats
    return out[False]


def phase_times_layer_norm_bwd(torch, ln, dev):
    """LayerNorm backward kernel, plain and library
    (torch.ops.aten.native_layer_norm_backward, timed alone on the
    forward's mean and rstd) times at the training shape, x [64, 128,
    512] fp32. The timed calls cycle through input copies that together
    exceed four times the L2 cache."""
    shape, C = (TRAIN_B, TRAIN_T, 512), 512
    n = TRAIN_B * TRAIN_T * 512
    L, l2 = _l2_copies(torch, dev, n * 4 * 3)
    gen = torch.Generator(dev).manual_seed(SEED + 24)
    x = torch.randn((L,) + shape, device=dev, generator=gen)
    dy = torch.randn((L,) + shape, device=dev, generator=gen)
    g = 1 + 0.2 * torch.randn(C, device=dev, generator=gen)
    b = 0.1 * torch.randn(C, device=dev, generator=gen)
    aten = torch.ops.aten
    fwd = [aten.native_layer_norm(x[j], [C], g, b, 1e-5) for j in range(L)]

    def kern(i):
        return ln.layer_norm_bwd(dy[i % L], x[i % L], g, 1e-5)

    def plain(i):
        return ln.layer_norm_bwd_plain(dy[i % L], x[i % L], g, 1e-5)

    def library(i):
        j = i % L
        return aten.native_layer_norm_backward(
            dy[j], x[j], [C], fwd[j][1], fwd[j][2], g, b,
            [True, True, True])

    lib = library(0)
    got = kern(0)
    lib_err = max(float((a - w).abs().max()) for a, w in zip(got, lib))
    k_ms = device_ms(torch, kern, 500)
    p_ms = device_ms(torch, plain, 60)
    l_ms = device_ms(torch, library, 500)
    k2_ms = device_ms(torch, kern, 500)
    rows = n // C
    nbytes = 3 * n * 4 + 3 * C * 4
    ops = 16 * n
    bound_ms, bound_by = _bound(nbytes, ops)
    log(f"[times] layer_norm_bwd x={list(shape)} fp32 ({rows} rows; {L} "
        f"input copies "
        f"cycled, L2 {l2} B): kernel_ms={k_ms:.6f} (repeat {k2_ms:.6f}) "
        f"bound_us={bound_ms * 1e3:.3f} ({bound_by}: {nbytes} B, {ops} "
        f"ops) plain_ms={p_ms:.6f} library_ms(native_layer_norm_backward)="
        f"{l_ms:.6f} library_vs_kernel_max_abs={lib_err:.3e}")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": l_ms}


# ------------------------------------------------ the sparse/CTR slice
# bench.py --sparse (bench.py:1315-1356): DeepFM through the sharded
# engine on one card, SGD(0.1), ids 30 % from 1000 hot ids
CTR_B, CTR_F, CTR_D, CTR_VOCAB, CTR_LR = 512, 26, 8, 100_000_000, 0.1
# bench.py:544-547: DeepFM on the plain Executor, is_sparse, Adam(1e-3)
DENSE_B, DENSE_VOCAB, DENSE_D, DENSE_LR = 4096, 8_000_000, 16, 1e-3
# lookup_pool against its plain version at the op's shapes: the
# registered kernel tolerance (ops/kern/registrations.py); at the
# engine's shape (F = 1) the kernel copies rows and must be bit-exact
LOOKUP_TOL = 2e-5
# its backward (plain PyTorch on either device) against autograd
# through the plain version: the JAX test's gradient tolerance
# (tests/test_pallas_embedding.py)
LOOKUP_GRAD_TOL = 2e-4
# DeepFM card vs CPU (vocab 1e5, B 64, 3 SGD steps from one scope):
# losses and every persistable within CTR_TOL (cuBLAS and the CPU BLAS
# sum the 400-wide tower in different orders, ~1e-7); rows no step
# touched bit for bit unchanged. Adam, one step from a copied state:
# the gradients as in training (TRAIN_GRAD_RTOL), and the card's new
# rows, moments and tower within TRAIN_ADAM_RTOL of the port's
# sparse_adam / adam ops run on the CPU on the card's own gradients.
CTR_TOL = 1e-5


def ctr_feed(B, F, vocab, seed):
    """bench.py:1349-1356's traffic: 30 % of the ids from 1000 hot ids,
    the rest uniform; values in [0, 1); labels 0 / 1."""
    rng = np.random.RandomState(seed)
    hot = rng.randint(0, vocab, 1000)
    flat = np.where(rng.rand(B * F) < 0.3, hot[rng.randint(0, 1000, B * F)],
                    rng.randint(0, vocab, B * F))
    return {"feat_ids": flat.reshape(B, F, 1).astype("int64"),
            "feat_vals": rng.rand(B, F).astype("float32"),
            "label": rng.randint(0, 2, (B, 1)).astype("float32")}


def build_deepfm(core, vocab, D, opt, dist):
    main, startup = core.framework.Program(), core.framework.Program()
    with core.framework.program_guard(main, startup), \
            core.unique_name.guard():
        _feeds, loss, _prob = core.deepfm.build_program(
            num_fields=CTR_F, vocab_size=vocab, embed_dim=D,
            is_distributed=dist)
        (core.optimizer.SGD(CTR_LR) if opt == "sgd"
         else core.optimizer.Adam(DENSE_LR)).minimize(loss)
    main.random_seed = startup.random_seed = SEED
    return main, startup, loss


def _engine_shape_inputs(torch, sp, dev):
    """The engine's lookup_pool inputs at bench.py --sparse's batch: the
    distinct rows u_rows [M, D] and inv [M, 1] of M = 512 x 26 ids
    (`unique_static` of ctr_feed's ids), for D = 1 and 8."""
    ids = torch.from_numpy(ctr_feed(CTR_B, CTR_F, CTR_VOCAB, 1)[
        "feat_ids"].reshape(-1)).to(dev)
    uids, inv, count = sp.unique_static(ids)
    gen = torch.Generator(dev).manual_seed(SEED + 30)
    tables = {d: torch.randn((ids.numel(), d), device=dev, generator=gen)
              for d in (1, 8)}
    return tables, inv[:, None], int(count)


def _op_shape_inputs(torch, dev, seed):
    """The op's shape, bench.py:544-547's batch over its table: table
    [8e6, 16], inv [4096, 26] with ~10 % padding (-1), a row with one id
    five times, a row of padding only, weights in [0.5, 1.5)."""
    gen = torch.Generator(dev).manual_seed(seed)
    table = torch.randn((DENSE_VOCAB, DENSE_D), device=dev, generator=gen)
    inv = torch.randint(0, DENSE_VOCAB, (DENSE_B, CTR_F), device=dev,
                        generator=gen)
    pad = torch.rand((DENSE_B, CTR_F), device=dev, generator=gen) < 0.1
    inv = torch.where(pad, -1, inv)
    inv[1, :5] = 7
    inv[3] = -1
    w = 0.5 + torch.rand((DENSE_B, CTR_F), device=dev, generator=gen)
    return table, inv, w


def phase_lookup_pool_vs_plain(torch, emb, sp, registry, dev):
    """The lookup_pool kernel against its plain version on the card. At
    the engine's shapes (F = 1, sum, D 1 and 8, int64 inv) bit for bit.
    At the op's shapes (table [8e6, 16], inv [4096, 26]; sum and mean,
    weighted or not; padding, repeated ids, a row of padding only, and a
    NaN table row that one position looks up) within LOOKUP_TOL, NaNs
    in the same places; the launch count moves by one a call. The
    backward (d table, d weights of a mean pool with weights) against
    autograd through the plain version within LOOKUP_GRAD_TOL, and its
    d(table) twice bit for bit. The fused_embedding_seq_pool op's kernel
    function once on the card (ids [R, F, 1] with ids past the table and
    a padding_idx, a Weight, pooltype "average"): one launch, and within
    LOOKUP_TOL of the same op run on the CPU."""
    tables, inv, count = _engine_shape_inputs(torch, sp, dev)
    worst = 0.0
    for d, tab in tables.items():
        n0 = emb.LAUNCHES["lookup_pool"]
        got = emb.lookup_pool(tab, inv)
        torch.cuda.synchronize()
        check(emb.LAUNCHES["lookup_pool"] == n0 + 1, "lookup_pool count")
        want = emb.lookup_pool_plain(tab, inv)
        check(torch.equal(got, want), f"lookup_pool D={d} (engine shape) "
              f"is not bit-exact")
    table, inv2, w = _op_shape_inputs(torch, dev, SEED + 31)
    table[11] = float("nan")
    inv2[5, 2] = 11
    lines = []
    for pool in ("sum", "mean"):
        for weights in (None, w):
            got = emb.lookup_pool(table, inv2, weights, pool)
            want = emb.lookup_pool_plain(table, inv2, weights, pool)
            nan_g, nan_w = torch.isnan(got), torch.isnan(want)
            check(torch.equal(nan_g, nan_w) and bool(nan_g[5].all())
                  and int(nan_g.any(1).sum()) == int(
                      (inv2 == 11).any(1).sum()),
                  f"lookup_pool {pool}: NaNs differ")
            err = float((got - want).abs().nan_to_num(0.0).max())
            worst = max(worst, err)
            lines.append(f"{pool}{'+w' if weights is not None else ''} "
                         f"{err:.3e}")
            check(err <= LOOKUP_TOL, f"lookup_pool {pool}: {err}")
            check(bool((got[3] == 0).all()), "all-padding row is not 0")
    table[11] = 0.5
    op = registry.get_kernel("fused_embedding_seq_pool")
    ids = torch.where(inv2 < 0, 3, inv2 + 5)[:, :, None]    # 3: padding
    attrs = {"pooltype": "average", "padding_idx": 3}
    n0 = emb.LAUNCHES["lookup_pool"]
    got = op(registry.KernelCtx(device=dev), {"W": [table], "Ids": [ids],
                                              "Weight": [w]}, attrs)
    got = got["Out"][0]
    torch.cuda.synchronize()
    check(emb.LAUNCHES["lookup_pool"] == n0 + 1,
          "fused_embedding_seq_pool on the card launched no lookup_pool")
    cpu = torch.device("cpu")
    want = op(registry.KernelCtx(device=cpu),
              {"W": [table.to(cpu)], "Ids": [ids.to(cpu)],
               "Weight": [w.to(cpu)]}, attrs)["Out"][0]
    check(emb.LAUNCHES["lookup_pool"] == n0 + 1, "the CPU op launched")
    op_err = float((got.to(cpu) - want).abs().max())
    worst = max(worst, op_err)
    check(op_err <= LOOKUP_TOL, f"fused_embedding_seq_pool card vs CPU: "
          f"{op_err}")
    check(bool((got[3] == 0).all()), "op: all-padding row is not 0")
    dy = torch.randn((DENSE_B, DENSE_D), device=dev,
                     generator=torch.Generator(dev).manual_seed(SEED + 32))
    grads = []
    for _ in range(2):
        tab = table.clone().requires_grad_(True)
        wt = w.clone().requires_grad_(True)
        emb.lookup_pool(tab, inv2, wt, "mean").backward(dy)
        grads.append((tab.grad, wt.grad))
    tab = table.clone().requires_grad_(True)
    wt = w.clone().requires_grad_(True)
    emb.lookup_pool_plain(tab, inv2, wt, "mean").backward(dy)
    e_tab, ok_tab = _allclose_err(torch, grads[0][0], tab.grad,
                                  LOOKUP_GRAD_TOL)
    e_w, ok_w = _allclose_err(torch, grads[0][1], wt.grad, LOOKUP_GRAD_TOL)
    same = torch.equal(grads[0][0], grads[1][0]) and torch.equal(
        grads[0][1], grads[1][1])
    log(f"[lookup_pool vs plain] engine shapes (M={inv.shape[0]} rows, "
        f"{count} distinct, D 1 and 8, F 1, int64): bit-exact; op shape "
        f"(table [{DENSE_VOCAB}, {DENSE_D}], inv [{DENSE_B}, {CTR_F}], "
        f"~10 % padding, a NaN row): max_abs " + ", ".join(lines)
        + f" (bound {LOOKUP_TOL:.0e}), NaNs in the same places; backward "
        f"vs autograd through plain: d_table {e_tab:.3e}, d_w {e_w:.3e} "
        f"(bound allclose {LOOKUP_GRAD_TOL:.0e}); repeats bit for bit: "
        f"{same}; fused_embedding_seq_pool op (average, padding_idx, "
        f"Weight, ids clipped) card vs CPU max_abs {op_err:.3e}, 1 launch")
    check(ok_tab and ok_w, f"lookup_pool backward: {e_tab}, {e_w}")
    check(same, "lookup_pool backward does not repeat bit for bit")
    return worst


def phase_deepfm_engine(torch, kern, core, dev):
    """DeepFM through ParallelExecutor(sparse="shard") on the card at
    bench.py --sparse's configuration: B 512, F 26, embed_dim 8, deep
    (400, 400, 400), vocab 1e8, is_distributed tables, SGD(0.1); the
    tables' initializers stripped and the shards seeded on the card
    (init_shards). One warm-up step, then 20 steps on one feed. Every
    launch count is set to 0 just before the 20 steps and read just
    after: each step launches lookup_pool twice (one lookup a table) and
    no other kernel. Losses finite and falling."""
    main, startup, loss = build_deepfm(core, CTR_VOCAB, CTR_D, "sgd", True)
    tables = core.sparse.discover_tables(main)
    core.sparse.strip_table_init(startup, tables)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    scope = core.Scope()
    core.Executor(core.CUDAPlace(0)).run_startup(startup, scope=scope)
    pexe = core.ParallelExecutor(loss_name=loss.name, main_program=main,
                                 scope=scope, sparse="shard")
    t = time.perf_counter()
    pexe.sparse_engine.init_shards(scope, seed=1)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t
    feed = ctr_feed(CTR_B, CTR_F, CTR_VOCAB, 0)
    t = time.perf_counter()
    losses = [float(pexe.run(feed=feed, fetch_list=[loss])[0])]
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t
    n = 20
    for name in kern.LAUNCHES:
        kern.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    for _ in range(n):
        losses.append(float(pexe.run(feed=feed, fetch_list=[loss])[0]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    want = {k: 0 for k in launches}
    want["lookup_pool"] = 2 * n
    stats = {tb: scope.get(core.sparse.STATS_PREFIX + tb).cpu().numpy()
             for tb in tables}
    uniq = {tb: float(s[1] / s[0]) for tb, s in stats.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[deepfm engine] ParallelExecutor(sparse='shard') on one card: "
        f"B={CTR_B} F={CTR_F} embed_dim={CTR_D} deep (400, 400, 400) "
        f"vocab={CTR_VOCAB} tables {tables} (physical "
        f"{[pexe.sparse_engine.tables[tb].physical_shape for tb in tables]})"
        f", SGD({CTR_LR}); init_shards {t_init:.3f} s, warm-up step "
        f"{t_first:.3f} s; {n} steps wall_s={wall:.3f} examples_per_s="
        f"{n * CTR_B / wall:.1f} step_ms={wall / n * 1e3:.3f} "
        f"unique_ratio={uniq} max_memory_allocated={peak} B ({peak - before}"
        f" B above the {before} B held by earlier phases) "
        f"LAUNCHES={launches} (required {want}); losses (warm-up, then "
        f"steps 1-{n}): " + ", ".join(f"{x:.6f}" for x in losses))
    check(all(np.isfinite(losses)), f"a loss is not finite: {losses}")
    check(losses[-1] < losses[1], f"loss did not fall: {losses}")
    check(launches == want, f"LAUNCHES {launches} != {want}")
    return launches, pexe, loss, feed


def phase_deepfm_dense(torch, kern, core, dev):
    """DeepFM on the plain Executor at bench.py:544-547's configuration:
    B 4096, F 26, vocab 8e6, embed_dim 16, is_sparse tables (not
    distributed), Adam(1e-3), run_startup on the card; one warm-up step,
    then 10 steps. The dense path the engine is held against: it
    launches no kernel of the port."""
    main, startup, loss = build_deepfm(core, DENSE_VOCAB, DENSE_D, "adam",
                                       False)
    scope = core.Scope()
    exe = core.Executor(core.CUDAPlace(0))
    exe.run_startup(startup, scope=scope)
    feed = ctr_feed(DENSE_B, CTR_F, DENSE_VOCAB, 2)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0])]
    n = 10
    for name in kern.LAUNCHES:
        kern.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"[deepfm dense] Executor, is_sparse tables: B={DENSE_B} F={CTR_F} "
        f"embed_dim={DENSE_D} vocab={DENSE_VOCAB} Adam({DENSE_LR}); {n} "
        f"steps wall_s={wall:.3f} examples_per_s={n * DENSE_B / wall:.1f} "
        f"step_ms={wall / n * 1e3:.3f} LAUNCHES={dict(kern.LAUNCHES)}; "
        f"losses (warm-up, then steps 1-{n}): "
        + ", ".join(f"{x:.6f}" for x in losses))
    check(all(np.isfinite(losses)), f"a loss is not finite: {losses}")
    check(losses[-1] < losses[1], f"loss did not fall: {losses}")
    check(not any(kern.LAUNCHES.values()), "the dense path launched a "
          "kernel of the port")
    return exe, main, loss, scope, feed


def _run_ctr(core, main, loss, state, feeds, how, fetch=()):
    """Run `feeds` from numpy `state` through `how` ("engine-card",
    "engine-cpu" or "dense-cpu"): (losses, the fetches of the last
    step, the persistables after it in the logical layout)."""
    dev = "cpu" if how.endswith("cpu") else "cuda"
    scope = core.scope_from_numpy(state, dev)
    names = list(state)
    if how.startswith("engine"):
        pexe = core.ParallelExecutor(use_cuda=dev == "cuda",
                                     loss_name=loss.name, main_program=main,
                                     scope=scope, sparse="shard")
        out = [pexe.run(feed=f, fetch_list=[loss, *fetch]) for f in feeds]
    else:
        exe = core.Executor(core.CPUPlace())
        out = [exe.run(main, feed=f, fetch_list=[loss, *fetch], scope=scope)
               for f in feeds]
    return ([float(o[0]) for o in out], [np.asarray(x) for x in out[-1][1:]],
            core.scope_to_numpy(scope, names))


def phase_deepfm_card_vs_cpu(torch, core):
    """The engine on the card, the engine on the CPU and the plain
    Executor's is_sparse path on the CPU, from one scope made by
    run_startup on the CPU, at bench.py --sparse's widths with vocab 1e5
    and B 64. SGD, 3 steps: losses and every persistable within
    CTR_TOL, untouched rows bit for bit unchanged. Adam, one step from
    the CPU's state after two: gradients tensor by tensor as in
    training, the card's tables, moments and tower against the port's
    sparse_adam / adam ops run on the CPU on the card's gradients within
    TRAIN_ADAM_RTOL. On the card the engine's step repeats bit for bit
    (its segment sums add in a fixed order)."""
    vocab, B = 100_000, 64
    feeds = [ctr_feed(B, CTR_F, vocab, 10 + s) for s in range(3)]
    touched = np.unique(np.concatenate([f["feat_ids"].ravel()
                                        for f in feeds]))
    res = {}
    for opt in ("sgd", "adam"):
        main, startup, loss = build_deepfm(core, vocab, CTR_D, opt, True)
        scope = core.Scope()
        core.Executor(core.CPUPlace()).run_startup(startup, scope=scope)
        names = [v.name for v in main.persistable_vars()]
        res[opt] = (main, loss, core.scope_to_numpy(scope, names))
    main, loss, init = res["sgd"]
    tables = core.sparse.discover_tables(main)
    runs = {how: _run_ctr(core, main, loss, init, feeds, how)
            for how in ("engine-card", "engine-cpu", "dense-cpu")}
    again = _run_ctr(core, main, loss, init, feeds, "engine-card")
    repeat_sgd = again[0] == runs["engine-card"][0] and all(
        np.array_equal(again[2][n], runs["engine-card"][2][n])
        for n in init)
    card = runs["engine-card"]
    e_loss = e_state = 0.0
    unchanged = True
    untouched = np.setdiff1d(np.arange(vocab), touched)
    for how in ("engine-cpu", "dense-cpu"):
        e_loss = max(e_loss, max(abs(a - b) for a, b in
                                 zip(card[0], runs[how][0])))
        e_state = max(e_state, max(
            float(np.abs(card[2][n] - runs[how][2][n]).max()) for n in init))
    for how in runs:
        for tb in tables:
            unchanged &= np.array_equal(runs[how][2][tb][untouched],
                                        init[tb][untouched])
    # Adam: two CPU steps make the state, then one step on each side
    main, loss, init_a = res["adam"]
    _l, _f, state = _run_ctr(core, main, loss, init_a, feeds[:2],
                             "engine-cpu")
    bop = [op for op in main.global_block().ops
           if op.type == "backward_macro"][0]
    gnames = bop.outputs["Grads"]
    l_card, g_card, new_card = _run_ctr(core, main, loss, state, feeds[2:],
                                        "engine-card", gnames)
    l_cpu, g_cpu, _new = _run_ctr(core, main, loss, state, feeds[2:],
                                  "engine-cpu", gnames)
    again = _run_ctr(core, main, loss, state, feeds[2:], "engine-card",
                     gnames)
    repeat_adam = all(np.array_equal(again[2][n], new_card[n])
                      for n in state)
    g_bad, g_out, g_most, g_worst = _grad_parity(gnames, g_card, g_cpu)
    a_bad, a_param, a_moment = _sparse_adam_parity(
        torch, core.registry, main, state, dict(zip(gnames, g_card)),
        feeds[2], new_card)
    log(f"[deepfm card-vs-cpu] vocab={vocab} B={B} F={CTR_F} embed_dim="
        f"{CTR_D} deep (400, 400, 400). SGD({CTR_LR}), 3 steps, engine on "
        f"the card / engine on the CPU / dense is_sparse Executor on the "
        f"CPU: losses " + " / ".join(
            ", ".join(f"{x:.7f}" for x in runs[h][0]) for h in runs)
        + f"; max |loss diff| {e_loss:.3e}, max |persistable diff| "
        f"{e_state:.3e} (bound {CTR_TOL:.0e}); {untouched.size} untouched "
        f"rows unchanged bit for bit: {unchanged}; card repeats bit for "
        f"bit: {repeat_sgd}. Adam({DENSE_LR}), one step from the CPU's "
        f"state after two: loss card {l_card[0]:.7f} cpu {l_cpu[0]:.7f}; "
        f"gradients outside {g_out} of all elements, largest share "
        f"{g_most[0]:.3e} in {g_most[1]}, largest |diff| / own max "
        f"{g_worst[0]:.3e} in {g_worst[1]}; card's update against the "
        f"CPU's sparse_adam / adam ops on the card's gradients: params "
        f"|diff| / lr {a_param:.3e}, moments |diff| / own max "
        f"{a_moment:.3e}, {len(a_bad)} persistables outside (bound "
        f"{TRAIN_ADAM_RTOL:.0e}); card repeats bit for bit: {repeat_adam}")
    check(e_loss <= CTR_TOL and abs(l_card[0] - l_cpu[0]) <= CTR_TOL,
          f"DeepFM losses differ by {e_loss}")
    check(e_state <= CTR_TOL, f"DeepFM persistables differ by {e_state}")
    check(unchanged, "an untouched row changed")
    check(repeat_sgd and repeat_adam, "the engine's step does not repeat "
          "bit for bit on the card")
    check(not g_bad, f"DeepFM gradients: {g_bad[:10]}")
    check(not a_bad, f"DeepFM Adam update: {a_bad[:10]}")


def _sparse_adam_parity(torch, registry, main, state, grads, feed,
                        new_card):
    """The card's update of one Adam step against the port's `adam` and
    `sparse_adam` ops run on the CPU from `state` on the card's
    gradients `grads`: (persistables outside TRAIN_ADAM_RTOL, largest
    parameter |diff| over lr, largest moment |diff| over its tensor's
    largest)."""
    cpu = torch.device("cpu")
    ctx = registry.KernelCtx(device=cpu)
    failed, e_param, e_moment = [], 0.0, 0.0
    for op in main.global_block().ops:
        if op.type not in ("adam", "sparse_adam"):
            continue
        ins = {}
        for k, names in op.inputs.items():
            src = [grads[v] if k == "Grad" else feed[v] if k == "Ids"
                   else state[v] for v in names]
            ins[k] = [torch.from_numpy(np.array(a)) for a in src]
        out = registry.get_kernel(op.type)(ctx, ins, op.attrs)
        lr = float(state[op.inputs["LearningRate"][0]].reshape(-1)[0])
        for slot, (t,) in out.items():
            n = op.outputs[slot][0]
            want, got = t.numpy(), new_card[n]
            d = np.abs(got - want)
            if slot == "ParamOut":
                scale = lr
                e_param = max(e_param, float(d.max()) / lr)
            elif slot.startswith("Moment"):
                scale = float(np.abs(want).max())
                e_moment = max(e_moment, float(d.max()) / max(scale, 1e-30))
            else:
                if not np.array_equal(got, want):
                    failed.append(n)
                continue
            if (d > TRAIN_ADAM_RTOL * (np.abs(want) + scale)).any():
                failed.append(n)
    return failed, e_param, e_moment


def phase_deepfm_profile(torch, pexe, loss, feed):
    """Where one engine step's time goes (vocab 1e8): host wall per step
    over 5 unprofiled steps (after 2 more), then torch.profiler over 5
    steps: device busy time per step, the idle share, and the device
    kernels that take it (the port's own: lookup_pool_kernel)."""

    def once():
        return pexe.run(feed=feed, fetch_list=[loss])
    wall_ms, prof_ms, by_name = profile_window(torch, once, n=5, warm=2)
    busy_us = sum(by_name.values())
    share = idle_share(busy_us, prof_ms, "deepfm engine step")
    ours = sum(v for k, v in by_name.items() if "lookup_pool_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log(f"[profile] deepfm engine step (B={CTR_B}, vocab={CTR_VOCAB}): host "
        f"wall {wall_ms:.3f} ms/step unprofiled, {prof_ms:.3f} ms/step "
        f"profiled; device busy {busy_us / 1e3:.3f} ms/step -> idle share "
        f"{share:.3f} (profiled window; "
        f"{1 - busy_us / 1e3 / wall_ms:.3f} against the unprofiled wall); "
        f"{len(by_name)} device kernels, lookup_pool_kernel {ours:.1f} "
        f"us/step ({ours / busy_us:.3f} of device time); top device ops "
        f"us/step: " + "; ".join(f"{k[:60]}={v:.1f}" for k, v in top))


def phase_deepfm_dense_profile(torch, exe, main, loss, scope, feed):
    """The dense is_sparse path's step (vocab 8e6, B 4096): host wall,
    device busy and idle share, as phase_deepfm_profile."""

    def once():
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    wall_ms, prof_ms, by_name = profile_window(torch, once, n=3, warm=2)
    busy_us = sum(by_name.values())
    share = idle_share(busy_us, prof_ms, "deepfm dense step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[profile] deepfm dense step (B={DENSE_B}, vocab={DENSE_VOCAB}): "
        f"host wall {wall_ms:.3f} ms/step unprofiled, {prof_ms:.3f} ms/step "
        f"profiled; device busy {busy_us / 1e3:.3f} ms/step -> idle share "
        f"{share:.3f} (profiled window); top device ops us/step: "
        + "; ".join(f"{k[:60]}={v:.1f}" for k, v in top))


def phase_times_lookup_pool(torch, emb, sp, dev):
    """lookup_pool kernel, plain and library times. The engine's shape
    (the main path's: u_rows [13312, 8] and [13312, 1], inv [13312, 1]
    int64; library F.embedding) goes on the kernels line; the op's shape
    (table [8e6, 16], inv [4096, 26], weighted sum; library
    F.embedding_bag with per_sample_weights, the padding as weight 0)
    is logged beside it. Bounds count the bytes these inputs need: each
    distinct looked-up row once, the indices, weights and output once.
    The timed calls cycle through input copies that together exceed
    four times the L2 cache."""
    F = torch.nn.functional
    tables, inv, count = _engine_shape_inputs(torch, sp, dev)
    M = inv.shape[0]
    out = {}
    for d in (8, 1):
        L, l2 = _l2_copies(torch, dev, M * d * 4 + M * 8)
        tabs = tables[d].repeat(L, 1, 1)
        invs = inv.repeat(L, 1, 1)

        def kern(i, t=tabs, v=invs):
            return emb.lookup_pool(t[i % L], v[i % L])

        def plain(i, t=tabs, v=invs):
            return emb.lookup_pool_plain(t[i % L], v[i % L])

        def library(i, t=tabs, v=invs):
            return F.embedding(v[i % L][:, 0], t[i % L])

        lib_err = float((library(0) - kern(0)).abs().max())
        k_ms = device_ms(torch, kern, 500)
        p_ms = device_ms(torch, plain, 200)
        l_ms = device_ms(torch, library, 500)
        k2_ms = device_ms(torch, kern, 500)
        nbytes = count * d * 4 + M * 8 + M * d * 4
        bound_ms, bound_by = _bound(nbytes, 0)
        log(f"[times] lookup_pool engine shape u_rows=[{M}, {d}] inv=[{M}, "
            f"1] int64 ({count} distinct rows; {L} input copies cycled, L2 "
            f"{l2} B): kernel_ms={k_ms:.6f} (repeat {k2_ms:.6f}) bound_us="
            f"{bound_ms * 1e3:.4f} ({bound_by}: {nbytes} B) plain_ms="
            f"{p_ms:.6f} library_ms(F.embedding)={l_ms:.6f} "
            f"library_vs_kernel_max_abs={lib_err:.3e}")
        out[d] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "library_ms": l_ms}
    table, inv2, w = _op_shape_inputs(torch, dev, SEED + 33)
    R, Fn = inv2.shape
    L, l2 = _l2_copies(torch, dev, R * Fn * 12)
    invs = torch.stack([inv2.roll(j, 0) for j in range(L)])
    ws = torch.stack([w.roll(j, 0) for j in range(L)])
    w0 = torch.where(invs < 0, 0.0, ws)
    inv0 = invs.clamp(min=0)

    def kern(i):
        return emb.lookup_pool(table, invs[i % L], ws[i % L], "sum")

    def plain(i):
        return emb.lookup_pool_plain(table, invs[i % L], ws[i % L], "sum")

    def library(i):
        return F.embedding_bag(inv0[i % L], table, mode="sum",
                               per_sample_weights=w0[i % L])

    lib_err = float((library(0) - kern(0)).abs().max())
    k_ms = device_ms(torch, kern, 300)
    p_ms = device_ms(torch, plain, 30)
    l_ms = device_ms(torch, library, 300)
    k2_ms = device_ms(torch, kern, 300)
    valid = inv2 >= 0
    rows = int(torch.unique(inv2[valid]).numel())
    nbytes = rows * DENSE_D * 4 + R * Fn * (8 + 4) + R * DENSE_D * 4
    bound_ms, bound_by = _bound(nbytes, 2 * int(valid.sum()) * DENSE_D)
    log(f"[times] lookup_pool op shape table=[{DENSE_VOCAB}, {DENSE_D}] "
        f"inv=[{R}, {Fn}] int64 weighted sum ({rows} distinct rows; {L} "
        f"index copies cycled, L2 {l2} B): kernel_ms={k_ms:.6f} (repeat "
        f"{k2_ms:.6f}) bound_us={bound_ms * 1e3:.4f} ({bound_by}: {nbytes} "
        f"B) plain_ms={p_ms:.6f} library_ms(F.embedding_bag, "
        f"per_sample_weights)={l_ms:.6f} library_vs_kernel_max_abs="
        f"{lib_err:.3e}")
    return out[8]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only "
              "on a card", file=sys.stderr)
        return 2
    try:
        import types
        from paddle_tpu_torch import unique_name
        from paddle_tpu_torch.core import framework
        from paddle_tpu_torch.core.dtypes import convert_dtype
        from paddle_tpu_torch.core.executor import Executor
        from paddle_tpu_torch.core.place import CPUPlace, CUDAPlace
        from paddle_tpu_torch import optimizer
        from paddle_tpu_torch.core.scope import (Scope, scope_from_numpy,
                                                 scope_guard, scope_to_numpy)
        from paddle_tpu_torch.ops import kern, registry
        from paddle_tpu_torch.ops.kern import _build
        from paddle_tpu_torch.ops.kern import decode_attention as da
        from paddle_tpu_torch.ops.kern import embedding as emb
        from paddle_tpu_torch.ops.kern import flash_attention as fa
        from paddle_tpu_torch.ops.kern import layer_norm as ln
        from paddle_tpu_torch.ops.kern import quant as qt
        from paddle_tpu_torch.models import deepfm
        from paddle_tpu_torch.models import transformer as tfm
        from paddle_tpu_torch.parallel import ParallelExecutor
        from paddle_tpu_torch.parallel import sparse
        from paddle_tpu_torch.serving import decode as dec_mod
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    core = types.SimpleNamespace(
        framework=framework, unique_name=unique_name, Executor=Executor,
        CPUPlace=CPUPlace, CUDAPlace=CUDAPlace, Scope=Scope,
        scope_from_numpy=scope_from_numpy, scope_guard=scope_guard,
        scope_to_numpy=scope_to_numpy, convert_dtype=convert_dtype,
        optimizer=optimizer, registry=registry, deepfm=deepfm,
        sparse=sparse, ParallelExecutor=ParallelExecutor)
    t_start = time.perf_counter()
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        phase_device_and_build(torch, _build)
        err = {"decode_attend": phase_kernel_vs_plain(torch, da, dev),
               "quantize_int8_blockwise": phase_quant_vs_plain(torch, qt,
                                                               dev),
               "dequant_attend": phase_dequant_vs_plain(torch, da, qt,
                                                        dev),
               "layer_norm": phase_layer_norm_vs_plain(torch, ln, dev),
               "flash_attention": phase_flash_vs_plain(torch, fa, dev),
               "layer_norm_bwd": phase_layer_norm_bwd_vs_plain(torch, ln,
                                                               dev)}
        err.update(phase_flash_bwd_vs_plain(torch, fa, dev))
        err["lookup_pool"] = phase_lookup_pool_vs_plain(torch, emb, sparse,
                                                        registry, dev)
        cfg = tfm.TransformerConfig.base()
        params = base_params(tfm, cfg, SEED)
        # each path's counts are read just after its own run
        runs = {q: phase_serving(torch, kern, tfm, dec_mod, params, cfg,
                                 kv_quant=q) for q in (None, "int8")}
        launches = {"decode_attend": runs[None][0]["decode_attend"]}
        launches.update((k, runs["int8"][0][k]) for k in
                        ("dequant_attend", "quantize_int8_blockwise"))
        prog = phase_program(torch, kern, tfm, core, params, cfg, dev)
        launches.update((k, prog[0][k]) for k in ("layer_norm",
                                                  "flash_attention"))
        _l, p_exe, p_main, p_logits, p_scope, p_src, p_lens, p_ids = prog
        train = phase_train(torch, kern, tfm, core, dev)
        launches.update((k, train[0][k]) for k in (
            "flash_attention_dq", "flash_attention_dkv", "layer_norm_bwd"))
        _l, t_exe, t_main, t_cost, t_scope, t_feed = train
        ctr = phase_deepfm_engine(torch, kern, core, dev)
        launches["lookup_pool"] = ctr[0]["lookup_pool"]
        _l, c_pexe, c_loss, c_feed = ctr
        phase_deepfm_profile(torch, c_pexe, c_loss, c_feed)
        del ctr, c_pexe
        dense = phase_deepfm_dense(torch, kern, core, dev)
        phase_deepfm_dense_profile(torch, *dense)
        del dense
        phase_card_vs_cpu(tfm, params, cfg)
        phase_int8_card_vs_cpu(tfm, params, cfg)
        phase_int8_vs_fp32(tfm, params, cfg)
        phase_program_card_vs_cpu(core, p_main, p_logits, params, p_src,
                                  p_lens, p_ids, p_exe, p_scope)
        phase_train_card_vs_cpu(torch, tfm, core)
        phase_deepfm_card_vs_cpu(torch, core)
        times = {"decode_attend": phase_times(torch, da, runs[None][1],
                                              cfg, dev),
                 "quantize_int8_blockwise": phase_times_quant(torch, qt,
                                                              cfg, dev),
                 "dequant_attend": phase_times_dequant(
                     torch, da, runs["int8"][1], cfg, dev),
                 "layer_norm": phase_times_layer_norm(torch, ln, dev),
                 "flash_attention": phase_times_flash(torch, fa, dev),
                 "layer_norm_bwd": phase_times_layer_norm_bwd(torch, ln,
                                                              dev)}
        times.update(phase_times_flash_bwd(torch, fa, dev))
        times["lookup_pool"] = phase_times_lookup_pool(torch, emb, sparse,
                                                       dev)
        for _launches, steps, engine in runs.values():
            phase_step_profile(torch, engine, median_step(steps, 256), cfg)
        phase_program_profile(torch, p_exe, p_main, p_logits, p_scope,
                              p_src, p_lens, p_ids)
        phase_train_profile(torch, t_exe, t_main, t_cost, t_scope, t_feed)
    except Exception:           # noqa: BLE001 — any failed phase
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    where = {"decode_attend": ("decode_attention.cu",
                               "kern/decode_attention.py:108"),
             "dequant_attend": ("decode_attention.cu",
                                "kern/decode_attention.py:123"),
             "quantize_int8_blockwise": ("quant.cu", "kern/quant.py:79"),
             "layer_norm": ("layer_norm.cu", "pallas/layer_norm.py:67"),
             "flash_attention": ("flash_attention.cu",
                                 "pallas/flash_attention.py:234"),
             "flash_attention_dq": ("flash_attention.cu",
                                    "pallas/flash_attention.py:331"),
             "flash_attention_dkv": ("flash_attention.cu",
                                     "pallas/flash_attention.py:366"),
             "layer_norm_bwd": ("layer_norm.cu", "pallas/layer_norm.py:78"),
             "lookup_pool": ("embedding.cu", "pallas/embedding.py:78")}
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=f"paddle_tpu_torch/csrc/{src}",
        replaces=f"paddle_tpu/ops/{tpu}", launches=launches[name],
        max_abs_err=err[name], **times[name])
        for name, (src, tpu) in where.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
