"""PyTorch port — configs: the port's ArchConfig agrees with the reference
field by field, in its reduced() smoke form, and in param_count(), for the
registered archs (chatglm3-6b, falcon-mamba-7b, zamba2-7b; the MoE pair is
held to the reference in ``test_torch_moe.py``) and every reference arch's
config logic."""
import dataclasses

import pytest

from repro import configs as jcfg
from repro_torch import configs as tcfg
from repro_torch.configs import base as tbase


def _port_copy(ref_cfg):
    """Rebuild a reference ArchConfig (and its sub-configs) in the port."""
    kw = {}
    for f in dataclasses.fields(ref_cfg):
        v = getattr(ref_cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(tbase, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return tbase.ArchConfig(**kw)


def test_registry_holds_the_ported_archs():
    assert tcfg.list_archs() == ["chatglm3-6b", "falcon-mamba-7b",
                                 "granite-moe-3b-a800m",
                                 "llama4-scout-17b-a16e", "zamba2-7b"]
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("yi-34b")


@pytest.mark.parametrize("reduced", [False, True])
def test_chatglm3_matches_reference(reduced):
    ref = jcfg.get_config("chatglm3-6b")
    port = tcfg.get_config("chatglm3-6b")
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.layer_param_count() == ref.layer_param_count()
    assert port.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("reduced", [False, True])
def test_falcon_mamba_matches_reference(reduced):
    ref = jcfg.get_config("falcon-mamba-7b")
    port = tcfg.get_config("falcon-mamba-7b")
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.layer_param_count() == ref.layer_param_count()
    if not reduced:  # 64 layers, d_model 4096, d_inner 8192, d_state 16
        assert port.param_count() == 7_272_665_088
        assert (port.n_layers, port.ssm.d_inner(port.d_model),
                port.ssm.d_state, port.ssm.resolved_dt_rank(port.d_model)) \
            == (64, 8192, 16, 256)


def test_chatglm3_full_width_numbers():
    c = tcfg.get_config("chatglm3-6b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
            c.d_ff, c.vocab_size, c.rope) == (28, 4096, 32, 2, 128, 13696,
                                              65024, "2d")
    assert abs(c.param_count() / 1e9 - 6.2) < 0.15 * 6.2


@pytest.mark.parametrize("name", sorted(jcfg.REGISTRY))
def test_config_logic_matches_every_reference_arch(name):
    """The port's dataclass logic (derived head_dim, param counts, reduced
    smoke configs) agrees with the reference for every family, though only
    chatglm3-6b is registered in the port so far."""
    ref = jcfg.get_config(name)
    port = _port_copy(ref)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert port.reduced().param_count() == ref.reduced().param_count()
