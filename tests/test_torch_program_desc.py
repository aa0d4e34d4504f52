"""The port's Fluid front-end (paddle_tpu_torch.core.framework,
unique_name, layer_helper, param_attr, initializer, layers) against the
JAX package's: Transformer inference programs built by both packages
under `program_guard` and `unique_name.guard` have equal `to_desc()`
(ops, slots, var names, shapes, dtypes, attrs, parameters), for the
main and the startup program, fused and unfused q/k/v; the op census at
base width (built, not run); `clone(for_test)` and the desc round trip
across the two packages."""
import collections

import numpy as np
import pytest

from paddle_tpu import unique_name as jun
from paddle_tpu.core import framework as jfw
from paddle_tpu.models import transformer as jtfm
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import unique_name as tun
from paddle_tpu_torch.core import framework as tfw
from paddle_tpu_torch.models import transformer as ttfm

PKGS = {"jax": (jfw, jun, jtfm), "torch": (tfw, tun, ttfm)}


def build(pkg, cfg_kw=None, maxlen=32, base=False, argmax=False):
    """(main, startup, logits) of build_infer_program in fresh programs
    under a fresh name guard; the default programs and the name counters
    are left as they were."""
    fw, un, tm = PKGS[pkg]
    main, startup = fw.Program(), fw.Program()
    with fw.program_guard(main, startup), un.guard():
        cfg = tm.TransformerConfig.base() if base \
            else tm.TransformerConfig.tiny()
        for k, v in (cfg_kw or {}).items():
            setattr(cfg, k, v)
        _feeds, logits = tm.build_infer_program(cfg, maxlen=maxlen)
        if argmax:
            from paddle_tpu import layers as jlayers
            (jlayers if pkg == "jax" else tlayers).argmax(logits, axis=-1)
    return main, startup, logits


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_infer_program_desc_equals_the_reference(fused, dropout):
    got = build("torch", {"fused_qkv": fused, "dropout": dropout},
                argmax=True)
    want = build("jax", {"fused_qkv": fused, "dropout": dropout},
                 argmax=True)
    assert got[2].name == want[2].name
    for g, w in zip(got[:2], want[:2]):
        gd, wd = g.to_desc(), w.to_desc()
        assert [o["type"] for o in gd["blocks"][0]["ops"]] == \
            [o["type"] for o in wd["blocks"][0]["ops"]]
        assert gd["blocks"][0]["vars"] == wd["blocks"][0]["vars"]
        assert gd == wd
    params = [(p.name, p.shape, p.dtype) for p in got[0].all_parameters()]
    assert params == [(p.name, p.shape, p.dtype)
                      for p in want[0].all_parameters()]
    if fused:
        assert "enc0_qkv.w_0" in dict((n, s) for n, s, _d in params)
        assert "dec0_cross_kv.w_0" in dict((n, s) for n, s, _d in params)


def test_base_op_census():
    """build_infer_program(TransformerConfig.base(), maxlen=128): the
    census one Executor.run launches (18 flash_attention and 30
    layer_norm ops among them), and the startup program's 183
    parameters."""
    main, startup, _l = build("torch", base=True, maxlen=128)
    census = collections.Counter(op.type for op in main.global_block().ops)
    assert census == {"mul": 97, "reshape": 72, "elementwise_add": 54,
                      "dropout": 32, "layer_norm": 30,
                      "flash_attention": 18, "relu": 12, "scale": 4,
                      "sequence_mask": 2, "unsqueeze": 2,
                      "lookup_table": 2, "add_position_encoding": 2}
    scensus = collections.Counter(op.type
                                  for op in startup.global_block().ops)
    assert scensus == {"uniform_random": 97, "fill_constant": 84,
                       "gaussian_random": 2}
    assert len(main.all_parameters()) == 183
    fused, _s, _l = build("torch", {"fused_qkv": True}, base=True,
                          maxlen=128)
    fc = collections.Counter(op.type for op in fused.global_block().ops)
    assert fc["mul"] == 67 and fc["split"] == 18
    assert fc == collections.Counter(
        op.type for op in build("jax", {"fused_qkv": True}, base=True,
                                maxlen=128)[0].global_block().ops)


def test_names_restart_under_a_guard_and_programs_are_restored():
    before = (tfw.default_main_program(), tfw.default_startup_program())
    a = build("torch")[0]
    b = build("torch")[0]
    assert a.to_desc() == b.to_desc()
    assert (tfw.default_main_program(),
            tfw.default_startup_program()) == before


def test_clone_for_test_sets_dropout_is_test_and_drops_train_ops():
    main, _s, _l = build("torch", {"dropout": 0.1})
    blk = main.global_block()
    blk.append_op("increment", {"X": ["x"]}, {"Out": ["x"]},
                  {"is_train_only": True})
    test = main.clone(for_test=True)
    drop = [op for op in test.global_block().ops if op.type == "dropout"]
    assert drop and all(op.attrs["is_test"] for op in drop)
    assert not any(op.type == "increment"
                   for op in test.global_block().ops)
    assert test._is_test
    assert any(op.type == "increment" for op in blk.ops)
    assert not any(op.attrs["is_test"] for op in blk.ops
                   if op.type == "dropout")


def test_desc_round_trips_across_the_two_packages():
    tmain = build("torch", {"fused_qkv": True})[0]
    jmain = build("jax", {"fused_qkv": True})[0]
    assert jfw.Program.from_desc(tmain.to_desc()).to_desc() == \
        jmain.to_desc()
    assert tfw.Program.from_desc(jmain.to_desc()).to_desc() == \
        tmain.to_desc()


def test_layer_helper_reuses_a_named_parameter_and_rejects_a_new_shape():
    from paddle_tpu_torch.param_attr import ParamAttr
    main, startup = tfw.Program(), tfw.Program()
    with tfw.program_guard(main, startup), tun.guard():
        x = tlayers.data("x", shape=[4])
        tlayers.fc(x, 3, param_attr=ParamAttr(name="w"))
        tlayers.fc(x, 3, param_attr=ParamAttr(name="w"))
        with pytest.raises(ValueError, match="different shape"):
            tlayers.fc(x, 5, param_attr=ParamAttr(name="w"))
    assert [op.type for op in startup.global_block().ops].count(
        "uniform_random") == 1
    assert np.prod(main.global_block().var("w").shape) == 12


@pytest.mark.parametrize("layer,kw", [
    ("fc", {"is_test": True}),
    ("dropout", {"seed": 3}),
    ("reshape", {"actual_shape": None}),
    ("reshape", {"act": "relu"}),
    ("reshape", {"inplace": True}),
    ("multi_head_attention", {"cache": {}}),
])
def test_arguments_the_reference_ignores_are_refused(layer, kw):
    """The reference's layers accept these arguments and ignore them;
    the port does not take them, so a caller learns the option has no
    effect instead of getting none silently."""
    main, startup = tfw.Program(), tfw.Program()
    with tfw.program_guard(main, startup), tun.guard():
        x = tlayers.data("x", shape=[4, 8], dtype="float32")
        args = {"fc": (x, 8), "dropout": (x, 0.1), "reshape": (x, [0, 32]),
                "multi_head_attention": (x, x, x)}[layer]
        with pytest.raises(TypeError, match=next(iter(kw))):
            getattr(tlayers, layer)(*args, **kw)
