"""The port's checkpoints, reference-checkpoint loading and weight transfer,
and checkpoints carried between the port and the JAX package both ways
(CPU, float32, weights made with numpy from a seed)."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cat_tpu import cli as jcli
from cat_tpu.compress.shrink import PruneBounds as JBounds
from cat_tpu.compress.shrink import shrink_generator as jax_shrink
from cat_tpu.compress.transfer import transfer_generator_params
from cat_tpu.core import config as jcfg
from cat_tpu.models.discriminators import NLayerDiscriminator as JDisc
from cat_tpu.models.generator import InceptionGenerator as JGen
from cat_tpu.utils import checkpoint as jckpt
from cat_tpu.utils.torch_import import import_inception_generator
from cat_tpu.utils.torch_import import recover_generator_config as jax_recover
from cat_tpu_torch import cli
from cat_tpu_torch.compress.transfer import _topk_desc, transfer_generator_state_dict
from cat_tpu_torch.core import config as tcfg
from cat_tpu_torch.entry import _load_net
from cat_tpu_torch.models.discriminators import NLayerDiscriminator
from cat_tpu_torch.models.generator import InceptionGenerator
from cat_tpu_torch.utils import checkpoint as ckpt
from cat_tpu_torch.utils import jax_import
from cat_tpu_torch.utils.torch_import import load_torch_generator, recover_generator_config
from tests.conftest import fast_init

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_gen_fixture.npz")
SIZE = 32


def to_port(cfg):
    return tcfg.config_from_json(jcfg.config_to_json(cfg))


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _gen_cfg(ngf, n_blocks=3, kernels=(1, 3)):
    return jcfg.InceptionGeneratorConfig.make(
        ngf=ngf, channels_reduction_factor=2, kernel_sizes=kernels, n_blocks=n_blocks,
        norm=jcfg.NormConfig(kind="instance", affine=True, track_running_stats=False))


def _spread_scales(variables, seed=0):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (np.asarray(rs.uniform(0.05, 2.0, x.shape), np.float32)
                         if path[-1].key == "scale" else np.asarray(x)), variables)


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------


def test_net_and_state_round_trip(tmp_path):
    cfg = to_port(_gen_cfg(4))
    sd = InceptionGenerator(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    path = ckpt.save_net(str(tmp_path), "best", "G", sd, cfg)
    assert path.endswith("best_net_G.pth")
    assert os.path.exists(str(tmp_path / "best_net_G.json"))
    loaded, cfg2 = ckpt.load_net(str(tmp_path), "best", "G")
    assert cfg2 == cfg and loaded.keys() == sd.keys()
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    state = {"step": 3, "g": {"opt": {"count": 3, "mu": {"w": torch.ones(2, 2)}}},
             "rng": torch.Generator().manual_seed(1).get_state()}
    ckpt.save_train_state(str(tmp_path), "latest", state)
    back = ckpt.load_train_state(str(tmp_path), "latest")
    assert back["step"] == 3 and back["g"]["opt"]["count"] == 3
    assert torch.equal(back["g"]["opt"]["mu"]["w"], torch.ones(2, 2))
    assert torch.equal(back["rng"], state["rng"])
    assert not any(p.endswith(".tmp") for p in os.listdir(tmp_path))


def test_copy_tag_duplicates_checkpoint_files(tmp_path):
    sd = {"w": torch.arange(6.0).reshape(2, 3)}
    ckpt.save_net(str(tmp_path), "latest", "G", sd)
    ckpt.save_train_state(str(tmp_path), "latest", sd)
    assert ckpt.copy_tag(str(tmp_path), "latest", "best") == 2
    assert torch.equal(ckpt.load_net(str(tmp_path), "best", "G")[0]["w"], sd["w"])
    # prefix safety: '1' must not match '10_*'
    ckpt.save_train_state(str(tmp_path), "1", sd)
    ckpt.save_train_state(str(tmp_path), "10", sd)
    assert ckpt.copy_tag(str(tmp_path), "1", "one") == 1


def test_copy_tag_removes_stale_and_respects_sibling_tags(tmp_path):
    sd = {"w": torch.arange(4.0)}
    ckpt.save_net(str(tmp_path), "best", "G", sd)
    ckpt.save_train_state(str(tmp_path), "best", sd)
    ckpt.save_net(str(tmp_path), "best_A", "G", {"w": sd["w"] * 2})
    sd2 = {"w": sd["w"] + 10}
    ckpt.save_net(str(tmp_path), "latest", "G", sd2)
    assert ckpt.copy_tag(str(tmp_path), "latest", "best") == 1
    assert not os.path.exists(str(tmp_path / "best_state.pth"))
    assert torch.equal(ckpt.load_net(str(tmp_path), "best", "G")[0]["w"], sd2["w"])
    assert torch.equal(ckpt.load_net(str(tmp_path), "best_A", "G")[0]["w"], sd["w"] * 2)
    ckpt.save_meta(str(tmp_path), "best", {"fid": 1.5})
    assert ckpt.load_meta(str(tmp_path), "best") == {"fid": 1.5}


def test_read_msgpack_equals_flax(tmp_path):
    """The JAX package's .msgpack layout, decoded without flax: arrays of
    several dtypes (bfloat16 widened to float32 exactly), numpy scalars,
    nested dicts and lists."""
    from flax import serialization

    rs = np.random.RandomState(0)
    tree = {"params": {"a": rs.randn(3, 4).astype(np.float32),
                       "b": {"c": np.arange(5, dtype=np.int32)}},
            "bf": jnp.asarray(rs.randn(7), jnp.bfloat16),
            "step": np.int32(4), "seq": [np.zeros(2), 1.5]}
    path = str(tmp_path / "t.msgpack")
    jckpt.save_pytree(path, tree)
    got = ckpt.read_msgpack(path)
    with open(path, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    flat_g, flat_r = _flatten(got), _flatten(ref)
    assert flat_g.keys() == flat_r.keys()
    for k in flat_r:
        np.testing.assert_array_equal(flat_g[k], np.asarray(flat_r[k], dtype=flat_g[k].dtype),
                                      err_msg=k)
    assert flat_g["bf"].dtype == np.float32


def test_read_msgpack_names_the_missing_package(tmp_path, monkeypatch):
    path = str(tmp_path / "t.msgpack")
    jckpt.save_pytree(path, {"w": np.zeros(2)})
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError, match="'msgpack' package"):
        ckpt.read_msgpack(path)


# ---------------------------------------------------------------------------
# Reference .pth generators (mirrors tests/test_torch_import.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fixture():
    data = np.load(FIXTURE)
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")}
    return data["x"], data["ref"], sd


def test_config_recovery_equals_the_jax_package(fixture):
    _, _, sd = fixture
    cfg = recover_generator_config(sd)
    assert cfg.ds_channels == (8, 16, 32) and cfg.us_channels == (16, 8)
    assert len(cfg.blocks) == 3
    assert cfg.blocks[0].res_kernels == (1, 3, 5)
    assert cfg.blocks[0].res_channels == (16, 16, 16)
    assert cfg == to_port(jax_recover({k: v.numpy() for k, v in sd.items()}))


def test_forward_matches_reference_output(fixture, tmp_path):
    """The reference model's captured output, through ``.pth`` loading and
    shape-driven config recovery (tolerance of tests/test_torch_import.py)."""
    x, ref, sd = fixture
    path = str(tmp_path / "ref.pth")
    torch.save(sd, path)
    cfg, loaded = load_torch_generator(path)
    gen = InceptionGenerator(cfg)
    gen.load_state_dict(loaded)
    with torch.no_grad():
        out = gen(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref, atol=2e-4)


# ---------------------------------------------------------------------------
# Weight transfer (mirrors tests/test_transfer.py)
# ---------------------------------------------------------------------------


def _transfer_both(src_cfg, dst_cfg, variables):
    """(JAX transfer, port transfer carried to the JAX layout) of the same
    weights."""
    jt = transfer_generator_params(variables["params"], src_cfg, dst_cfg)
    src_sd = jax_import.generator_state_dict(variables["params"], src_cfg)
    tsd = transfer_generator_state_dict(src_sd, to_port(src_cfg), to_port(dst_cfg))
    InceptionGenerator(to_port(dst_cfg)).load_state_dict(tsd)  # the student's keys and shapes
    _, back = import_inception_generator({k: v.numpy() for k, v in tsd.items()}, dst_cfg)
    return _flatten(jt), _flatten(back["params"])


def _assert_same(ref, got):
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_topk_order_matches_torch_topk():
    q = np.array([0.1, 5.0, 3.0, 4.0])
    assert list(_topk_desc(q, 3)) == [1, 3, 2]
    assert list(_topk_desc(q, 3)) == torch.topk(torch.from_numpy(q), 3).indices.tolist()


def test_transfer_equals_the_jax_package():
    """Narrower uniform student and self-transfer (a pure magnitude
    permutation): the same tensors as the JAX package's transfer."""
    src_cfg = _gen_cfg(8)
    v = fast_init(JGen(src_cfg), jnp.zeros((1, SIZE, SIZE, 3)), seed=0)
    _assert_same(*_transfer_both(src_cfg, _gen_cfg(4), v))
    ref, got = _transfer_both(src_cfg, src_cfg, v)
    _assert_same(ref, got)
    q = np.abs(np.asarray(v["params"]["stem"]["conv"]["kernel"])).sum(axis=(0, 1, 2))
    np.testing.assert_array_equal(
        got["stem/conv/kernel"],
        np.asarray(v["params"]["stem"]["conv"]["kernel"])[:, :, :, np.argsort(-q, kind="stable")])
    # the head keeps the image channels and its bias
    np.testing.assert_array_equal(got["head/bias"], np.asarray(v["params"]["head"]["bias"]))


def test_transfer_into_pruned_config_equals_the_jax_package():
    """--restore_pretrained_G_path together with --target_flops: the
    transfer into a shrink-pruned (irregular-width) student."""
    from cat_tpu.compress.profiling import profile_generator

    cfg = _gen_cfg(8, kernels=(1, 3, 5))
    v = _spread_scales(fast_init(JGen(cfg), jnp.zeros((1, SIZE, SIZE, 3)), seed=0))
    res = jax_shrink(cfg, v, profile_generator(cfg, SIZE, SIZE).macs * 0.5, SIZE, SIZE,
                     JBounds(cin_lb=2))
    assert res.config != cfg
    _assert_same(*_transfer_both(cfg, res.config, v))


def test_transfer_matches_branches_by_index_not_position():
    """With the student's branch 0 pruned away, branches pair by original
    index: the surviving 3x3 branch keeps its own teacher kernel."""
    src_cfg = _gen_cfg(8)
    blocks = tuple(dataclasses.replace(b, res_channels=(0,) + b.res_channels[1:],
                                       dw_channels=(0,) + b.dw_channels[1:])
                   for b in src_cfg.blocks)
    dst_cfg = dataclasses.replace(src_cfg, blocks=blocks)
    v = fast_init(JGen(src_cfg), jnp.zeros((1, SIZE, SIZE, 3)), seed=0)
    ref, got = _transfer_both(src_cfg, dst_cfg, v)
    _assert_same(ref, got)
    assert got["block0/res1_in/conv/kernel"].shape[:2] == (3, 3)


# ---------------------------------------------------------------------------
# Checkpoints between the two packages
# ---------------------------------------------------------------------------


def _jax_forward(cfg, params, x_nchw):
    out = JGen(cfg).apply({"params": params}, jnp.asarray(x_nchw.transpose(0, 2, 3, 1)))
    return np.asarray(out).transpose(0, 3, 1, 2)


def test_jax_msgpack_generator_and_d_load_into_the_port(tmp_path, rng):
    """A generator and a D written by the JAX package's ``save_net`` load
    into the port (the recipes' --restore_*_path), and the generator gives
    the JAX package's output (atol 1e-5: float32 convolutions summed in
    another order)."""
    cfg = _gen_cfg(4)
    gv = _spread_scales(fast_init(JGen(cfg), jnp.zeros((1, SIZE, SIZE, 3)), seed=1))
    jckpt.save_net(str(tmp_path), "best_A", "G_A", gv, cfg)
    dcfg = jcfg.NLayerDiscriminatorConfig(input_nc=3, ndf=8,
                                          norm=jcfg.NormConfig(kind="instance", affine=True))
    dv = fast_init(JDisc(dcfg), jnp.zeros((1, SIZE, SIZE, 3)), seed=2)
    jckpt.save_net(str(tmp_path), "best_A", "D_A", dv)

    norm = tcfg.NormConfig(kind="instance", affine=True)
    tcfg_, sd = cli.load_generator_checkpoint(str(tmp_path / "best_A_net_G_A.msgpack"), norm)
    assert tcfg_ == to_port(cfg)
    gen = InceptionGenerator(tcfg_)
    gen.load_state_dict(sd)
    x = rng.randn(2, 3, SIZE, SIZE).astype(np.float32)
    with torch.no_grad():
        out = gen(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, _jax_forward(cfg, gv["params"], x), atol=1e-5)

    disc = NLayerDiscriminator(to_port(dcfg))
    dsd = _load_net(str(tmp_path / "best_A_net_D_A.msgpack"),
                    lambda t: jax_import.discriminator_net_state_dict(t, to_port(dcfg)), "D")
    disc.load_state_dict(dsd)
    with torch.no_grad():
        d_out = disc(torch.from_numpy(x)).numpy()
    d_ref = JDisc(dcfg).apply(dv, jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(d_out, np.asarray(d_ref).transpose(0, 3, 1, 2), atol=1e-5)


def test_port_pth_loads_into_the_jax_package(tmp_path, rng):
    """A generator the port's ``save_net`` writes loads through the JAX
    package's ``cli.load_generator_checkpoint`` with no change there, and
    gives the port's output (atol 1e-5)."""
    cfg = to_port(_gen_cfg(4))
    gen = InceptionGenerator(cfg, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for k, p in gen.named_parameters():
            if p.dim() == 1 and k.endswith(".weight"):
                p.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(4))
    path = ckpt.save_net(str(tmp_path), "latest", "G", gen.state_dict(), cfg)
    jcfg_, jv = jcli.load_generator_checkpoint(
        path, jcfg.NormConfig(kind="instance", affine=True))
    assert to_port(jcfg_) == cfg
    x = rng.randn(2, 3, SIZE, SIZE).astype(np.float32)
    with torch.no_grad():
        out = gen(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, _jax_forward(jcfg_, jv["params"], x), atol=1e-5)
