#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, `paddle_tpu_torch`, on one
NVIDIA GPU (written for the H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every kernel of the serving path from `paddle_tpu_torch/csrc/`,
holds each kernel against its plain PyTorch version on the card, serves
Transformer-base greedy decode through `ContinuousScheduler` ->
`DecodeEngine` -> `IncrementalDecoder` with random weights made from a
seed, checks that every decode step went through the kernel, compares
the card's logits and tokens with the port's CPU run, and times each
kernel beside its bound, its plain version and a PyTorch library call.

It imports nothing of JAX or of `paddle_tpu`. Where CUDA is not
available, or any phase fails, it exits non-zero and prints no result.
Its last two lines are a JSON object of per-kernel numbers and then
``{"ok": true, "device": {...}}``.
"""
import json
import os
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


# --------------------------------------------------------------- phases
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
    _build.load("decode_attention")
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)} from "
        f"{os.path.relpath(_build.CSRC)}/decode_attention.cu, "
        f"build and load: {time.perf_counter() - t0:.2f} s")
    return card


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


def phase_serving(torch, da, tfm, dec_mod, params, cfg):
    """Transformer-base continuous decode on the card: 48 requests of
    mixed source lengths and budgets, half of them arriving while the
    first half is in flight."""
    engine = dec_mod.DecodeEngine(
        cfg, params, dec_mod.DecodeEngineConfig(num_slots=32, max_len=256))
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
    da.LAUNCHES = 0
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
    launches = da.LAUNCHES
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
    log(f"[serve] Transformer-base d_model={cfg.d_model} "
        f"d_inner={cfg.d_inner} heads={cfg.n_head} layers={cfg.n_layer} "
        f"vocab={cfg.trg_vocab}; slots=32 max_len=256: "
        f"requests={len(results)} tokens={tokens} "
        f"distinct_tokens={distinct} distinct_streams={streams} "
        f"in_flight_at_second_wave={in_flight} "
        f"wall_s={wall:.3f} tokens_per_s={tokens / wall:.1f} "
        f"decode_steps={len(steps)} LAUNCHES={launches} "
        f"(= {cfg.n_layer} x {len(steps)} required); host time in "
        f"steps_s={spent['step']:.3f} (mean_step_ms="
        f"{spent['step'] / max(1, len(steps)) * 1e3:.3f}) "
        f"admit_prefill_s={spent['admit']:.3f} "
        f"rest_s={wall - spent['step'] - spent['admit']:.3f}")
    check(in_flight > 0, "second wave did not arrive mid-flight")
    check(distinct > 1 and streams > 1, "every request decoded alike")
    check(len(steps) > 0 and launches == cfg.n_layer * len(steps),
          f"LAUNCHES {launches} != {cfg.n_layer} x {len(steps)} steps")
    return launches, steps, engine


def phase_step_profile(torch, engine, pick, cfg):
    """Where one decode step's time goes with all 32 slots live at the
    serving run's median positions: host wall per step, device busy
    time per step from torch.profiler, and the kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    n = 20
    for _ in range(3):
        dec.step(state, ids, pick)
    t = time.perf_counter()
    for _ in range(n):
        dec.step(state, ids, pick)
    wall_ms = (time.perf_counter() - t) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            dec.step(state, ids, pick)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / n
    busy_us = sum(by_name.values())
    if busy_us == 0:
        log(f"[profile] decode step, 32 live slots: host wall "
            f"{wall_ms:.3f} ms/step; device time not visible to "
            f"torch.profiler (not measured)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    attn = sum(v for k, v in by_name.items() if "decode_attend" in k)
    log(f"[profile] decode step, 32 live slots, attended_rows="
        f"{int(np.minimum(pick + 1, dec.max_len).sum())}: host wall "
        f"{wall_ms:.3f} ms/step (unprofiled); device busy "
        f"{busy_us / 1e3:.3f} ms/step -> idle share "
        f"{max(0.0, 1 - busy_us / 1e3 / wall_ms):.3f}; decode_attend "
        f"{attn:.2f} us/step ({attn / busy_us:.3f} of device time); "
        f"top device ops us/step: "
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
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    L = -(-4 * l2 // (2 * n_rows * H * Dh * 4))
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
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[times] decode_attend S={S} T={T} H={H} Dh={Dh} "
        f"attended_rows={n_rows} (median step of {len(steps)}), "
        f"{L} cache copies cycled (L2 {l2} B): "
        f"kernel_ms={k_ms:.6f} (repeat {k2_ms:.6f}) "
        f"bound_us={bound_ms * 1e3:.3f} ({bound_by}: {nbytes} B, "
        f"{flops} flop) plain_ms={p_ms:.6f} library_ms(sdpa)={l_ms:.6f} "
        f"sdpa_vs_kernel_max_abs={lib_err:.3e}")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": l_ms}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only "
              "on a card", file=sys.stderr)
        return 2
    try:
        from paddle_tpu_torch.ops.kern import _build
        from paddle_tpu_torch.ops.kern import decode_attention as da
        from paddle_tpu_torch.models import transformer as tfm
        from paddle_tpu_torch.serving import decode as dec_mod
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        phase_device_and_build(torch, _build)
        max_err = phase_kernel_vs_plain(torch, da, dev)
        cfg = tfm.TransformerConfig.base()
        params = base_params(tfm, cfg, SEED)
        launches, steps, engine = phase_serving(torch, da, tfm, dec_mod,
                                                params, cfg)
        phase_card_vs_cpu(tfm, params, cfg)
        times = phase_times(torch, da, steps, cfg, dev)
        phase_step_profile(torch, engine, median_step(steps, 256), cfg)
    except Exception:           # noqa: BLE001 — any failed phase
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [dict(
        name="decode_attend", route="cuda",
        source="paddle_tpu_torch/csrc/decode_attention.cu",
        replaces="paddle_tpu/ops/kern/decode_attention.py:108",
        launches=launches, max_abs_err=max_err, **times)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
