"""The port's incremental decoder (paddle_tpu_torch.models.transformer)
against the JAX `IncrementalDecoder` on the CPU, from the same numpy
parameters: prefill caches and step logits within a stated fp32
tolerance, greedy tokens identical, `kv_cache_bytes` equal, and the
fused checkpoint layout loading through `params_from_numpy`."""
import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as jtfm
from paddle_tpu_torch.models import transformer as ttfm

# fp32 on both sides; XLA and PyTorch sum matmuls in different orders,
# and the difference grows through the layer stack to ~1e-5 here
RTOL = ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, restored afterwards, so the
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(mod, max_len=12):
    return mod.TransformerConfig(src_vocab=64, trg_vocab=64,
                                 max_len=max_len, d_model=32, d_inner=64,
                                 n_head=4, n_layer=2, dropout=0.0,
                                 label_smooth_eps=0.0)


def seeded_params(cfg, seed):
    """Unfused transformer parameters with wide seeded random values,
    so argmax varies across rows (as tests/test_serving_decode.py
    draws them)."""
    shapes = ttfm.param_shapes(cfg)
    rng = np.random.RandomState(seed)
    out = {}
    for n in sorted(shapes):
        shp = shapes[n]
        if n.startswith("layer_norm") and n.endswith(".w_0"):
            a = 1.0 + 0.2 * rng.randn(*shp)
        elif n.endswith(".b_0"):
            a = 0.1 * rng.randn(*shp)
        else:
            a = 0.35 * rng.randn(*shp)
        out[n] = a.astype(np.float32)
    return out


def _sources(n_rows, width, seed):
    rng = np.random.RandomState(seed)
    lens = rng.randint(3, width + 1, n_rows)
    src = np.zeros((n_rows, width), np.int64)
    for r, n in enumerate(lens):
        src[r, :n] = rng.randint(2, 60, n)
    return src, lens.astype(np.int64)


def _run(dec, srcs, steps):
    """prefill all slots, then `steps` greedy steps from bos at pos 0;
    returns (prefill_out as numpy, [tokens], [logits])."""
    src, lens = srcs
    state = dec.init_state()
    out = dec.prefill(src, lens)
    pre = [np.asarray(o if not torch.is_tensor(o) else o.cpu())
           for o in out]
    state = dec.write_slots(state, out, list(range(src.shape[0])))
    ids = np.zeros(dec.num_slots, np.int64)
    pos = np.zeros(dec.num_slots, np.int64)
    toks, logits = [], []
    for _ in range(steps):
        nxt = dec.step(state, ids, pos)
        toks.append(np.asarray(nxt, np.int64))
        logits.append(np.asarray(dec.last_logits))
        ids, pos = toks[-1], pos + 1
    return pre, toks, logits


def test_decoder_matches_jax_prefill_logits_and_greedy_tokens():
    params = seeded_params(tiny_cfg(jtfm), seed=7)
    srcs = _sources(3, 12, seed=5)
    jdec = jtfm.IncrementalDecoder(tiny_cfg(jtfm), params, num_slots=3,
                                   max_len=12, return_logits=True)
    tdec = ttfm.IncrementalDecoder(tiny_cfg(ttfm), params, num_slots=3,
                                   max_len=12, return_logits=True,
                                   device="cpu")
    jpre, jtok, jlog = _run(jdec, srcs, steps=10)
    tpre, ttok, tlog = _run(tdec, srcs, steps=10)
    for name, a, b in zip(("ck", "cv", "src_bias"), jpre, tpre):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    for t, (a, b) in enumerate(zip(jlog, tlog)):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {t} logits")
    np.testing.assert_array_equal(np.stack(ttok), np.stack(jtok))
    # the tokens are not degenerate: argmax varies across slots/steps
    assert len(np.unique(np.stack(jtok))) > 3


@pytest.mark.parametrize("num_slots,max_len,src_max_len",
                         [(3, 12, None), (5, 16, 9)])
def test_kv_cache_bytes_equal(num_slots, max_len, src_max_len):
    params = seeded_params(tiny_cfg(jtfm), seed=1)
    j = jtfm.IncrementalDecoder(tiny_cfg(jtfm), params, num_slots,
                                max_len=max_len, src_max_len=src_max_len)
    t = ttfm.IncrementalDecoder(tiny_cfg(ttfm), params, num_slots,
                                max_len=max_len, src_max_len=src_max_len,
                                device="cpu")
    assert t.kv_cache_bytes() == j.kv_cache_bytes()
    state = t.init_state()
    assert sum(v.numel() * v.element_size() for v in state.values()) \
        == t.kv_cache_bytes()


def test_fused_checkpoint_layout_gives_the_same_tokens():
    params = seeded_params(tiny_cfg(jtfm), seed=13)
    fused = jtfm.convert_qkv_checkpoint(params, tiny_cfg(jtfm),
                                        to_fused=True)
    assert any(k.endswith("_qkv.w_0") for k in fused)
    assert any(k.endswith("_cross_kv.w_0") for k in fused)
    loaded = ttfm.params_from_numpy(fused, tiny_cfg(ttfm), device="cpu")
    for n, a in ttfm.decode_params(params, tiny_cfg(ttfm)).items():
        np.testing.assert_array_equal(loaded[n].numpy(), a)
    srcs = _sources(2, 10, seed=3)
    jdec = jtfm.IncrementalDecoder(tiny_cfg(jtfm, 10), params,
                                   num_slots=2, return_logits=True)
    tdec = ttfm.IncrementalDecoder(tiny_cfg(ttfm, 10), fused, num_slots=2,
                                   return_logits=True, device="cpu")
    _, jtok, _ = _run(jdec, srcs, steps=6)
    _, ttok, _ = _run(tdec, srcs, steps=6)
    np.testing.assert_array_equal(np.stack(ttok), np.stack(jtok))


def test_int8_cache_is_the_next_slice():
    params = seeded_params(tiny_cfg(ttfm), seed=2)
    with pytest.raises(NotImplementedError, match="next slice"):
        ttfm.IncrementalDecoder(tiny_cfg(ttfm), params, 2,
                                kv_quant="int8", device="cpu")


def test_topk_sampling_is_seeded_and_stays_in_the_top_k():
    """top-k draws come from a torch.Generator seeded by the step's
    seed: the same seed repeats them, and each draw is one of the k
    largest logits. (They cannot match jax.random's draws.)"""
    params = seeded_params(tiny_cfg(ttfm), seed=4)
    srcs = _sources(4, 12, seed=8)

    def draws(seed):
        dec = ttfm.IncrementalDecoder(tiny_cfg(ttfm), params, 4, topk=3,
                                      return_logits=True, device="cpu")
        state = dec.write_slots(dec.init_state(), dec.prefill(*srcs),
                                list(range(4)))
        nxt = dec.step(state, np.zeros(4, np.int64),
                       np.zeros(4, np.int64), seed=seed)
        return nxt, dec.last_logits

    a, logits = draws(11)
    b, _ = draws(11)
    np.testing.assert_array_equal(a, b)
    top3 = np.argsort(-logits, axis=-1)[:, :3]
    assert all(tok in row for tok, row in zip(a, top3))


def test_step_rejects_positions_outside_the_cache():
    params = seeded_params(tiny_cfg(ttfm), seed=2)
    dec = ttfm.IncrementalDecoder(tiny_cfg(ttfm), params, 2, device="cpu")
    state = dec.init_state()
    with pytest.raises(ValueError, match="positions"):
        dec.step(state, np.zeros(2, np.int64), np.array([0, 12]))


@pytest.mark.parametrize("preset", ["base", "tiny"])
def test_config_presets_match_jax(preset):
    assert vars(getattr(ttfm.TransformerConfig, preset)()) \
        == vars(getattr(jtfm.TransformerConfig, preset)())
