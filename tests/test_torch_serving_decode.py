"""The port's continuous-decode serving tier (paddle_tpu_torch.serving.
decode) against the JAX package's: continuous batching with staggered
arrivals and early eos is token-identical to one-at-a-time decode
through the JAX `DecodeEngine`; deadline, cancel, queue-full,
preemption and shutdown outcomes match the JAX scheduler's on the same
scripted traffic; the supervised loop recovers from a crash without
leaking slots; and `stop(drain=True)` leaves no live thread."""
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as jtfm
from paddle_tpu.serving import decode as jdecode
from paddle_tpu_torch.models import transformer as ttfm
from paddle_tpu_torch.serving import decode as tdecode
from test_torch_transformer_decode import seeded_params, tiny_cfg


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeEngine:
    """Microsecond engine for scheduler tests: a fixed token per step."""

    def __init__(self, num_slots=4, max_new_tokens=100, src_max_len=64,
                 tok=7, fail_on_step=None):
        self.num_slots = num_slots
        self.max_new_tokens = max_new_tokens
        self.src_max_len = src_max_len
        self.tok = tok
        self.fail_on_step = fail_on_step
        self.steps = 0

    def init_state(self):
        return {}

    def warmup(self):
        return 1

    def admit(self, state, requests, slots):
        return state

    def step(self, state, ids, pos, seed=0):
        self.steps += 1
        if self.steps == self.fail_on_step:
            raise RuntimeError("injected step failure")
        return np.full(self.num_slots, self.tok, np.int32)


def _req(n=4, tenant="default", **kw):
    return dict(src=np.arange(2, 2 + n), tenant=tenant, **kw)


def _outcome(fut):
    """'ok:<n tokens>' or the error class name (classes differ between
    the two packages; their names and meanings do not)."""
    if not fut.done():
        return "pending"
    try:
        return f"ok:{len(fut.result(timeout=0).tokens)}"
    except Exception as e:      # noqa: BLE001 — the outcome under test
        return type(e).__name__


# ------------------------------------------------------ decode parity
def test_continuous_batching_token_identical_to_one_at_a_time_jax():
    maxlen = 12
    params = seeded_params(tiny_cfg(jtfm), seed=7)
    rng = np.random.RandomState(5)
    reqs = []
    for _ in range(7):
        n = int(rng.randint(3, maxlen + 1))
        reqs.append((rng.randint(2, 60, (n,)).astype(np.int64), n,
                     int(rng.randint(3, maxlen))))

    # reference: the JAX engine, one request at a time, no eos
    jeng = jdecode.DecodeEngine(tiny_cfg(jtfm), params,
                                jdecode.DecodeEngineConfig(
                                    num_slots=3, max_len=maxlen,
                                    prefill_buckets=(1, 2, 4)))
    jsched = jdecode.ContinuousScheduler(jeng, warmup=False)
    full = []
    for src, n, max_new in reqs:
        f = jsched.submit(src, src_len=n, max_new_tokens=max_new)
        while not f.done():
            jsched.run_iteration()
        full.append(np.asarray(f.result(timeout=0).tokens, np.int64))
    # an eos that fires mid-stream in some request; with eos set, a
    # greedy stream is the same stream cut after its first eos
    eos = int(full[0][1])
    expected = []
    for toks in full:
        hits = np.nonzero(toks == eos)[0]
        expected.append(toks[:hits[0] + 1] if len(hits) else toks)
    assert any(len(e) < m for e, (_s, _n, m) in zip(expected, reqs))

    teng = tdecode.DecodeEngine(tiny_cfg(ttfm), params,
                                tdecode.DecodeEngineConfig(
                                    num_slots=3, max_len=maxlen,
                                    prefill_buckets=(1, 2, 4)),
                                device="cpu")
    sched = tdecode.ContinuousScheduler(
        teng, config=tdecode.DecodeConfig(bos=0, eos=eos), warmup=True)
    arrivals = {0: [0, 1], 1: [2], 3: [3, 4], 6: [5, 6]}
    futures = {}
    it = 0
    while len(futures) < len(reqs) \
            or not all(f.done() for f in futures.values()):
        for i in arrivals.get(it, ()):
            src, n, max_new = reqs[i]
            futures[i] = sched.submit(src, src_len=n,
                                      max_new_tokens=max_new)
        sched.run_iteration()
        it += 1
        assert it < 500, "continuous decode did not converge"
    for i, f in futures.items():
        got = np.asarray(f.result(timeout=0).tokens, np.int64)
        np.testing.assert_array_equal(got, expected[i], err_msg=str(i))
    reasons = {f.result(timeout=0).finish_reason for f in futures.values()}
    assert reasons == {"eos", "length"}
    assert sched.pool.free_count() == teng.num_slots
    sched.pool.check()


@pytest.mark.parametrize("kv_block", [None, 4])
def test_int8_continuous_batching_token_identical_to_one_at_a_time(kv_block):
    """The int8 engine through the scheduler: slots are independent
    rows, so staggered continuous batching gives exactly the tokens of
    the same engine serving each request alone."""
    maxlen = 12
    params = seeded_params(tiny_cfg(ttfm), seed=9)
    conf = tdecode.DecodeEngineConfig(num_slots=3, max_len=maxlen,
                                      prefill_buckets=(1, 2, 4),
                                      kv_quant="int8", kv_block=kv_block)
    rng = np.random.RandomState(6)
    reqs = []
    for _ in range(6):
        n = int(rng.randint(3, maxlen + 1))
        reqs.append((rng.randint(2, 60, (n,)).astype(np.int64), n,
                     int(rng.randint(3, maxlen))))
    engine = tdecode.DecodeEngine(tiny_cfg(ttfm), params, conf,
                                  device="cpu")
    fp32 = tdecode.DecodeEngine(tiny_cfg(ttfm), params,
                                tdecode.DecodeEngineConfig(
                                    num_slots=3, max_len=maxlen),
                                device="cpu")
    assert engine.kv_cache_bytes == engine.decoder.kv_cache_bytes() \
        < fp32.kv_cache_bytes
    sched = tdecode.ContinuousScheduler(engine, warmup=False)
    alone = []
    for src, n, max_new in reqs:
        f = sched.submit(src, src_len=n, max_new_tokens=max_new)
        while not f.done():
            sched.run_iteration()
        alone.append(np.asarray(f.result(timeout=0).tokens, np.int64))
    assert len({a.tobytes() for a in alone}) > 1

    sched = tdecode.ContinuousScheduler(engine, warmup=False)
    arrivals = {0: [0, 1], 1: [2], 3: [3, 4], 5: [5]}
    futures = {}
    it = 0
    while len(futures) < len(reqs) \
            or not all(f.done() for f in futures.values()):
        for i in arrivals.get(it, ()):
            src, n, max_new = reqs[i]
            futures[i] = sched.submit(src, src_len=n,
                                      max_new_tokens=max_new)
        sched.run_iteration()
        it += 1
        assert it < 500, "continuous decode did not converge"
    for i, f in futures.items():
        np.testing.assert_array_equal(
            np.asarray(f.result(timeout=0).tokens, np.int64), alone[i],
            err_msg=str(i))
    assert sched.pool.free_count() == engine.num_slots
    sched.pool.check()


# ----------------------------------------- admission-control parity
def _deadline_and_queue_full(mod):
    sched = mod.ContinuousScheduler(
        FakeEngine(num_slots=1),
        config=mod.DecodeConfig(max_queue_requests=2), warmup=False)
    f1 = sched.submit(**_req(deadline_ms=60))
    sched.submit(**_req())
    out = []
    try:
        sched.submit(**_req())
    except Exception as e:      # noqa: BLE001
        out.append(type(e).__name__)
    try:
        f1.result()             # the deadline-aware wait
    except Exception as e:      # noqa: BLE001
        out.append(type(e).__name__)
    sched2 = mod.ContinuousScheduler(
        FakeEngine(num_slots=1),
        config=mod.DecodeConfig(max_queue_requests=8), warmup=False)
    f = sched2.submit(**_req(max_new_tokens=90, deadline_ms=50))
    sched2.run_iteration()
    out.append(sched2.pool.active_count())
    time.sleep(0.07)
    sched2.run_iteration()
    out += [_outcome(f), sched2.pool.free_count()]
    return out


def _cancel(mod):
    sched = mod.ContinuousScheduler(
        FakeEngine(num_slots=1), config=mod.DecodeConfig(),
        warmup=False)
    running = sched.submit(**_req(max_new_tokens=50))
    queued = sched.submit(**_req(max_new_tokens=50))
    sched.run_iteration()
    out = [sched.cancel(queued), _outcome(queued),
           sched.cancel(running), _outcome(running)]
    sched.run_iteration()       # the loop retires the flagged slot
    out += [_outcome(running), sched.pool.free_count(),
            sched.cancel(running)]
    return out


def _preemption(mod):
    sched = mod.ContinuousScheduler(
        FakeEngine(num_slots=4), qos=mod.QosPolicy(preemption=True),
        config=mod.DecodeConfig(max_queue_requests=64), warmup=False)
    hogs = [sched.submit(**_req(tenant="hog", max_new_tokens=90))
            for _ in range(4)]
    sched.run_iteration()
    small = sched.submit(**_req(tenant="small", max_new_tokens=2))
    sched.run_iteration()
    sched.run_iteration()
    return [sched.preemptions, sorted(_outcome(f) for f in hogs),
            _outcome(small)]


def _wfq(mod):
    qos = mod.QosPolicy(tenants=[mod.TenantClass("a", weight=1.0),
                                 mod.TenantClass("b", weight=3.0)])
    sched = mod.ContinuousScheduler(
        FakeEngine(num_slots=4), qos=qos,
        config=mod.DecodeConfig(max_queue_requests=512), warmup=False)
    futs = {t: [sched.submit(**_req(tenant=t, max_new_tokens=5))
                for _ in range(60)] for t in ("a", "b")}
    for _ in range(40):
        sched.run_iteration()
    return {t: sum(len(f.result(timeout=0).tokens)
                   for f in fs if f.done()) for t, fs in futs.items()}


def _shutdown_and_oversized(mod):
    sched = mod.ContinuousScheduler(
        FakeEngine(num_slots=1, src_max_len=8), config=mod.DecodeConfig(),
        warmup=False)
    out = []
    try:
        sched.submit(src=np.arange(20))
    except Exception as e:      # noqa: BLE001
        out.append(type(e).__name__)
    running = sched.submit(**_req(max_new_tokens=50))
    queued = sched.submit(**_req(max_new_tokens=50))
    sched.run_iteration()
    sched.stop(drain=False)
    out += [_outcome(running), _outcome(queued), sched.pool.free_count()]
    try:
        sched.submit(**_req())
    except Exception as e:      # noqa: BLE001
        out.append(type(e).__name__)
    return out


SCENARIOS = {
    "deadline_and_queue_full": (
        _deadline_and_queue_full,
        ["RejectedError", "DeadlineExceeded", 1, "DeadlineExceeded", 1]),
    "cancel": (_cancel, [True, "CancelledError", True, "pending",
                         "CancelledError", 1, False]),
    "preemption": (_preemption,
                   [1, ["PreemptedError", "pending", "pending",
                        "pending"], "ok:2"]),
    "wfq": (_wfq, None),
    "shutdown_and_oversized": (
        _shutdown_and_oversized,
        ["RejectedError", "ServerClosed", "ServerClosed", 1,
         "ServerClosed"]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_admission_control_matches_jax_scheduler(name):
    run, expected = SCENARIOS[name]
    got = run(tdecode)
    assert got == run(jdecode)
    if expected is not None:
        assert got == expected
    else:                       # wfq: weights 1:3 split slot-time ~1:3
        assert 2.2 < got["b"] / got["a"] < 3.8, got


# ---------------------------------------------------- loop lifecycle
def _decode_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("ptt-decode-") and t.is_alive()]


def test_supervised_loop_recovers_from_a_crash_without_leaking_slots():
    engine = FakeEngine(num_slots=2, fail_on_step=2)
    sched = tdecode.ContinuousScheduler(
        engine, config=tdecode.DecodeConfig(idle_wait_s=0.01),
        warmup=False)
    try:
        # both queued before the loop starts, so both hold a slot when
        # step 2 fails, however the threads are scheduled
        doomed = [sched.submit(**_req(max_new_tokens=5))
                  for _ in range(2)]
        sched.start()
        for f in doomed:
            with pytest.raises(RuntimeError, match="injected"):
                f.result(timeout=10)
        later = sched.submit(**_req(max_new_tokens=3))
        assert len(later.result(timeout=10).tokens) == 3
        assert sched.restarts == 1
        sched.pool.check()
    finally:
        sched.stop(drain=True, timeout=10)
    assert sched.pool.free_count() == 2
    assert not _decode_threads()


def test_stop_drain_serves_everything_and_leaves_no_thread():
    params = seeded_params(tiny_cfg(ttfm), seed=3)
    engine = tdecode.DecodeEngine(
        tiny_cfg(ttfm), params,
        tdecode.DecodeEngineConfig(num_slots=2, max_len=12),
        device="cpu")
    sched = tdecode.ContinuousScheduler(
        engine, config=tdecode.DecodeConfig(idle_wait_s=0.01))
    try:
        sched.start()
        futs = [sched.submit(np.arange(2, 2 + n), max_new_tokens=m)
                for n, m in ((3, 4), (6, 2), (9, 5), (4, 3))]
    finally:
        sched.stop(drain=True, timeout=30)
    assert [len(f.result(timeout=0).tokens) for f in futs] == [4, 2, 5, 3]
    assert not sched.alive and not _decode_threads()


def test_engine_from_scope_and_rolling_set_params():
    """`from_scope` picks the decode parameters out of a {name: ndarray}
    mapping in the fused layout among unrelated entries; `set_params`
    swaps weights of the same shapes and refuses a new architecture."""
    cfg = tiny_cfg(ttfm)
    params = seeded_params(cfg, seed=3)
    scope = dict(ttfm.convert_qkv_checkpoint(params, cfg, to_fused=True))
    scope["learning_rate_0"] = np.ones(1, np.float32)
    conf = tdecode.DecodeEngineConfig(num_slots=2, max_len=12)

    def tokens(engine):
        sched = tdecode.ContinuousScheduler(engine, warmup=False)
        f = sched.submit(np.arange(2, 9), max_new_tokens=6)
        while not f.done():
            sched.run_iteration()
        return list(f.result(timeout=0).tokens)

    want = tokens(tdecode.DecodeEngine(cfg, params, conf, device="cpu"))
    assert tokens(tdecode.DecodeEngine.from_scope(scope, cfg, conf,
                                                  device="cpu")) == want
    other = tdecode.DecodeEngine(cfg, seeded_params(cfg, seed=4), conf,
                                 device="cpu")
    assert tokens(other) != want
    other.set_params(params)
    assert tokens(other) == want
    wide = seeded_params(tiny_cfg(ttfm), seed=5)
    wide["proj.w_0"] = np.zeros((32, 65), np.float32)
    with pytest.raises(ValueError, match="proj.w_0"):
        other.set_params(wide)


@pytest.mark.parametrize("kind", ["reference", "port"])
@pytest.mark.parametrize("with_names", [False, True])
def test_engine_from_scope_takes_a_scope_object(kind, with_names):
    """`from_scope` reads a scope through `get` and `__contains__`: the
    JAX package's Scope (jax arrays) and the port's (tensors) build the
    same engine as the parameter dict, with and without an explicit
    `names` list, in the fused checkpoint layout among unrelated
    entries."""
    from paddle_tpu.core.scope import Scope as JScope
    from paddle_tpu_torch.core.scope import scope_from_numpy
    cfg = tiny_cfg(ttfm)
    params = seeded_params(cfg, seed=3)
    fused = dict(ttfm.convert_qkv_checkpoint(params, cfg, to_fused=True))
    fused["learning_rate_0"] = np.ones(1, np.float32)
    if kind == "reference":
        import jax.numpy as jnp
        scope = JScope()
        for n, a in fused.items():
            scope.set(n, jnp.asarray(a))
    else:
        scope = scope_from_numpy(fused, torch.device("cpu"))
    assert not hasattr(scope, "__getitem__")
    names = sorted(n for n in fused if n != "learning_rate_0") \
        if with_names else None
    conf = tdecode.DecodeEngineConfig(num_slots=2, max_len=12)

    def tokens(engine):
        sched = tdecode.ContinuousScheduler(engine, warmup=False)
        f = sched.submit(np.arange(2, 9), max_new_tokens=6)
        while not f.done():
            sched.run_iteration()
        return list(f.result(timeout=0).tokens)

    want = tokens(tdecode.DecodeEngine(cfg, params, conf, device="cpu"))
    got = tdecode.DecodeEngine.from_scope(scope, cfg, conf, names=names,
                                          device="cpu")
    assert tokens(got) == want
    for n, t in got.decoder.params.items():
        assert torch.equal(t, torch.from_numpy(params[n]))
