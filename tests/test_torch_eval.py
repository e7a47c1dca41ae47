"""The port's FID evaluation against the JAX package's, on the CPU: the
InceptionV3 judge, the Fréchet distance, KID, the FID evaluator, and the
get_real_stat, profile and KID verbs.  The judge's weights are random from
a seed, in the pt_inception-2015-12-05 key layout, written by the port and
read by both packages; images are numpy-seeded PNGs.  The port is NCHW, the
JAX package NHWC."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cat_tpu.metrics import fid as jfid
from cat_tpu.metrics import kid as jkid
from cat_tpu.metrics.inception import InceptionV3FID as JInception
from cat_tpu.metrics.inception import convert_torch_inception
from cat_tpu.metrics.inception import load_inception as jax_load_inception
from cat_tpu_torch import entry
from cat_tpu_torch.metrics import fid as tfid
from cat_tpu_torch.metrics import kid as tkid
from cat_tpu_torch.metrics.inception import (InceptionV3FID, load_inception, resize_299,
                                             write_random_judge)
from tests.test_torch_verb import SIZE, _args, world  # noqa: F401  (fixture)

torch.set_num_threads(2)

# the Fréchet distances of the two packages' judges: float32 features that
# agree to ~1e-6 of their scale, through the same numpy/scipy code
FID_RTOL = 1e-3


@pytest.fixture(scope="module")
def judge(tmp_path_factory):
    """A seeded random judge: its state_dict, its .pth, and the port's
    module loaded from that file."""
    path = str(tmp_path_factory.mktemp("judge") / "judge.pth")
    write_random_judge(path, seed=1)
    return {"sd": torch.load(path, weights_only=True), "path": path,
            "model": load_inception(path, device="cpu")}


def _nhwc(t):
    return np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t).transpose(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# The judge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(64, 48), (320, 352)], ids=["upsample", "downsample"])
def test_inception_matches_the_jax_package(judge, hw):
    """Blocks 0-3 of one forward (output_blocks (0, 1, 2, 3)) against the
    JAX judge on the same weights (its converter) and inputs, for an input
    that the resize to 299 enlarges and one it shrinks.  Tolerance: 1e-4 of
    each block's largest feature (float32 through ~90 layers)."""
    x = np.random.RandomState(hw[0]).uniform(0, 1, (2, 3) + hw).astype(np.float32)
    port = InceptionV3FID((0, 1, 2, 3))
    port.load_state_dict(judge["sd"])
    got = port(torch.from_numpy(x))
    ref = JInception(output_blocks=(0, 1, 2, 3)).apply(convert_torch_inception(judge["sd"]),
                                                       jnp.asarray(x.transpose(0, 2, 3, 1)))
    assert [tuple(g.shape) for g in got] == [(2, 64, 73, 73), (2, 192, 35, 35),
                                            (2, 768, 17, 17), (2, 2048)]
    for g, r in zip(got, ref):
        g = _nhwc(g) if g.dim() == 4 else g.numpy()
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * float(np.abs(r).max()))


@pytest.mark.parametrize("hw", [(64, 48), (299, 299), (320, 352), (600, 310)])
def test_resize_to_299_matches_jax_image_resize(hw):
    """Half-pixel bilinear, antialiased when it shrinks: within 3e-5 of
    ``jax.image.resize(..., "bilinear")`` on [0, 1] pixels (float32 weights
    computed and summed in another order); a shrink without the
    antialiasing would be visibly off."""
    x = np.random.RandomState(1).uniform(0, 1, (1, 3) + hw).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)), (1, 299, 299, 3),
                                      "bilinear"))
    got = _nhwc(resize_299(torch.from_numpy(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-5)
    plain = _nhwc(torch.nn.functional.interpolate(torch.from_numpy(x), size=(299, 299),
                                                  mode="bilinear", align_corners=False))
    shrinks = hw[0] > 299 or hw[1] > 299
    assert (float(np.abs(plain - ref).max()) > 1e-2) == shrinks


def test_output_blocks_stop_early_and_keep_their_order(judge):
    x = torch.from_numpy(np.random.RandomState(2).uniform(0, 1, (1, 3, 40, 40))
                         .astype(np.float32))
    full = InceptionV3FID((0, 1))
    full.load_state_dict(judge["sd"])
    want = full(x)
    for blocks in ((1,), (1, 0), (0,)):
        part = InceptionV3FID(blocks)
        part.load_state_dict(judge["sd"])
        got = part(x)
        assert len(got) == len(blocks)
        for g, b in zip(got, sorted(blocks)):
            assert torch.equal(g, want[b])


def test_judge_checkpoint_layout(judge, tmp_path):
    """The checkpoint loads strictly once its classifier heads are dropped;
    a missing tensor fails; the JAX package reads the port's file."""
    sd = dict(judge["sd"])
    assert len(sd) == 94 * 5 and "Mixed_7c.branch_pool.bn.running_var" in sd
    heads = {"fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008),
             "AuxLogits.conv0.conv.weight": torch.zeros(128, 768, 1, 1)}
    path = str(tmp_path / "with_heads.pth")
    torch.save({**sd, **heads}, path)
    model = load_inception(path, device="cpu")
    assert torch.equal(model.Mixed_5b.branch1x1.conv.weight, sd["Mixed_5b.branch1x1.conv.weight"])
    del sd["Mixed_6e.branch7x7_2.bn.weight"]
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_inception(path, device="cpu")
    _, variables = jax_load_inception(judge["path"])
    assert variables["params"]["Mixed_7c"]["branch_pool"]["conv"]["kernel"].shape == \
        (1, 1, 2048, 192)


# ---------------------------------------------------------------------------
# Fréchet distance, KID, get_fid, compute_real_stats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, d", [(40, 8), (5, 16)], ids=["regular", "singular"])
def test_frechet_distance_equals_the_jax_package(n, d):
    """The same numpy/scipy code on the same statistics, the singular
    retry included (5 samples of 16 features)."""
    rs = np.random.RandomState(d)
    a, b = rs.randn(n, d), rs.randn(n, d) * 1.3 + 0.2
    args = (*tfid.compute_statistics(a), *tfid.compute_statistics(b))
    assert tfid.calculate_frechet_distance(*args) == pytest.approx(
        jfid.calculate_frechet_distance(*args), rel=1e-12, abs=1e-12)
    with pytest.raises(ValueError, match="widths"):
        tfid.calculate_frechet_distance(args[0], args[1], args[2][:3], args[3][:3, :3])


def test_kid_equals_the_jax_package(rng):
    g, r = rng.randn(30, 16), rng.randn(25, 16) + 0.1
    assert tkid.kid_score(g, r, 10, 12, seed=3) == jkid.kid_score(g, r, 10, 12, seed=3)
    got = tkid.kid_score(g, r, 5, 8, seed=4, ret_var=True)
    want = jkid.kid_score(g, r, 5, 8, seed=4, ret_var=True)
    assert got[:2] == want[:2] and np.array_equal(got[2], want[2])


def test_get_fid_and_real_stats_match_the_jax_package(judge):
    """Five [-1, 1] images through both judges at batch 2 (the last batch
    padded): the real statistics to 1e-4 of their scale, FID to 1e-3
    relative; the port's padded batches equal one unpadded batch."""
    rs = np.random.RandomState(3)
    reals = rs.uniform(-1, 1, (5, 3, 24, 24)).astype(np.float32)
    fakes = np.tanh(reals * 2.0 + 0.3).astype(np.float32)
    model = judge["model"]
    _, jv = jax_load_inception(judge["path"])
    jmodel = JInception(output_blocks=(3,))

    stats = tfid.compute_real_stats(reals, model, batch_size=2)
    jstats = jfid.compute_real_stats(_nhwc(reals), jmodel, jv, batch_size=2)
    for k in ("mu", "sigma"):
        np.testing.assert_allclose(stats[k], jstats[k], rtol=0,
                                   atol=1e-4 * float(np.abs(jstats[k]).max()))
    got = tfid.get_fid(fakes, model, jstats, batch_size=2)
    want = jfid.get_fid(_nhwc(fakes), jmodel, jv, jstats, batch_size=2)
    assert got == pytest.approx(want, rel=FID_RTOL)

    u8 = tfid.tensor2im_batch(reals)
    np.testing.assert_array_equal(u8, jfid.tensor2im_batch(reals))
    np.testing.assert_allclose(tfid.get_activations(u8, model, 2),
                               tfid.get_activations(u8, model, 5), rtol=1e-5, atol=1e-5)
    assert tfid.get_fid_direct(reals, fakes, model, 2) > 0.0


# ---------------------------------------------------------------------------
# Image helpers and the evaluator
# ---------------------------------------------------------------------------


def test_tensor2im_and_html_equal_the_jax_package(tmp_path):
    from cat_tpu.utils import html as jhtml
    from cat_tpu.utils import image as jimage
    from cat_tpu_torch.utils import html as thtml
    from cat_tpu_torch.utils import image as timage

    x = np.random.RandomState(4).uniform(-1.2, 1.2, (3, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(timage.tensor2im(torch.from_numpy(x)),
                                  jimage.tensor2im(x.transpose(1, 2, 0)))
    np.testing.assert_array_equal(timage.tensor2im(x[None, :1]),
                                  jimage.tensor2im(x[:1].transpose(1, 2, 0)[None]))
    lab = np.random.RandomState(5).randint(0, 40, (4, 6))
    np.testing.assert_array_equal(timage.tensor2label(lab), jimage.tensor2label(lab))
    pages = []
    for mod in (thtml, jhtml):
        page = mod.HTML(str(tmp_path / mod.__name__), "t <1>", refresh=3)
        page.add_header("h & h")
        page.add_images(["a.png", "b.png"], ["a", "b"], ["a.png", "b.png"], width=64)
        pages.append(page.render())
    assert pages[0] == pages[1]


def _val_folder(root, n=3, size=(40, 36)):
    rs = np.random.RandomState(6)
    os.makedirs(root / "valA")
    for i in range(n):
        Image.fromarray(rs.randint(0, 256, (size[1], size[0], 3), dtype=np.uint8)).save(
            root / "valA" / f"v{i}.png")
    return str(root)


def test_fid_evaluator_matches_the_jax_package(judge, tmp_path):
    """The same generator (an elementwise function) over the same val
    folder: the same metric keys, FID within 1e-3 relative, the same dumped
    files and index.html; a second call on the same images keeps best and
    mean and raises no best flag."""
    from cat_tpu.data import datasets as jds
    from cat_tpu.data import transforms as jtf
    from cat_tpu.train.evaluation import FIDEvaluator as JEvaluator
    from cat_tpu_torch.data import datasets as tds
    from cat_tpu_torch.data import transforms as ttf
    from cat_tpu_torch.train.evaluation import FIDEvaluator, combine_evaluators

    root = _val_folder(tmp_path)
    spec = dict(preprocess="resize_and_crop", load_size=36, crop_size=32)
    stats = tfid.compute_real_stats(np.random.RandomState(7).uniform(
        -1, 1, (4, 3, 32, 32)).astype(np.float32), judge["model"], 4)
    _, jv = jax_load_inception(judge["path"])
    runs = {}
    for who in ("port", "jax"):
        log_dir = str(tmp_path / who)
        if who == "port":
            ev = FIDEvaluator(lambda x: torch.tanh(0.5 * x + 0.1),
                              tds.create_eval_dataloader("unaligned", root, 2,
                                                         ttf.TransformSpec(**spec)),
                              judge["model"], stats, log_dir, 2,
                              teacher_generate=lambda x: -x, device="cpu")
            evaluate = combine_evaluators(**{"": ev})
            calls = [evaluate(None, s) for s in (1, 2)]
        else:
            ev = JEvaluator(lambda x: np.tanh(0.5 * x + 0.1),
                            jds.create_eval_dataloader("unaligned", root, 2,
                                                       jtf.TransformSpec(**spec)),
                            JInception(output_blocks=(3,)), jv, stats, log_dir, 2,
                            teacher_generate=lambda x: -x)
            calls = [ev(1)]
        files = sorted(os.path.relpath(os.path.join(d, f), log_dir)
                       for d, _, fs in os.walk(log_dir) for f in fs)
        runs[who] = calls, files
    (pc, pf), (jc, jf) = runs["port"], runs["jax"]
    assert [f for f in pf if f.startswith("eval/1/")] == jf
    assert "eval/1/index.html" in pf and "eval/2/Tfake/v2.png" in pf
    assert [f for _, f in pc] == [{"is_best": True}, {}] and jc[0][1] == {"is_best": True}
    (m1, _), (m2, _), (jm, _) = *pc, jc[0]
    assert m1.keys() == jm.keys() == {"metric/fid", "metric/fid-mean", "metric/fid-best"}
    for k in m1:
        assert m1[k] == pytest.approx(jm[k], rel=FID_RTOL)
    # the same images again: the same FID, so neither best nor mean moves
    assert m2 == m1
    a = np.asarray(Image.open(tmp_path / "port" / "eval" / "1" / "Sfake" / "v0.png"))
    b = np.asarray(Image.open(tmp_path / "jax" / "eval" / "1" / "Sfake" / "v0.png"))
    assert int(np.abs(a.astype(int) - b).max()) <= 1


# ---------------------------------------------------------------------------
# The verbs: get_real_stat, profile, KID
# ---------------------------------------------------------------------------


def test_real_stat_verb_matches_the_jax_package(world, judge, tmp_path):  # noqa: F811
    from cat_tpu.entry import real_stat_main as jax_real_stat_main

    argv = ["--dataroot", os.path.join(world.data, "valB"), "--inception_path", judge["path"],
            "--load_size", "36", "--crop_size", str(SIZE), "--batch_size_stat", "3"]
    got = entry.real_stat_main(argv + ["--output_path", str(tmp_path / "p" / "s.npz")],
                               device="cpu")
    jax_real_stat_main(argv + ["--output_path", str(tmp_path / "j.npz")])
    saved, want = np.load(tmp_path / "p" / "s.npz"), np.load(tmp_path / "j.npz")
    assert np.array_equal(saved["mu"], got["mu"]) and saved["sigma"].shape == (2048, 2048)
    for k in ("mu", "sigma"):
        np.testing.assert_allclose(saved[k], want[k], rtol=0,
                                   atol=1e-4 * float(np.abs(want[k]).max()))
    with pytest.raises(SystemExit, match="inception weights"):
        entry.real_stat_main(argv[:2] + ["--inception_path", str(tmp_path / "absent.pth"),
                                         "--output_path", str(tmp_path / "x.npz")],
                             device="cpu")


def test_profile_verb_matches_the_jax_package(world, judge, tmp_path):  # noqa: F811
    """Shrink, MACs, parameters and the evaluation sweep of both packages'
    profile verbs on the same teacher, judge and PNGs: the same student,
    metric keys, FID within 1e-3 relative, and every val image dumped under
    the same names."""
    from cat_tpu.entry import profile_distill as jax_profile_distill

    stats = str(tmp_path / "stats.npz")
    entry.real_stat_main(["--dataroot", os.path.join(world.data, "valB"), "--inception_path",
                          judge["path"], "--load_size", "36", "--crop_size", str(SIZE),
                          "--output_path", stats], device="cpu")

    def argv(who):
        return _args(world, tmp_path / who, "--distill_G_loss_type", "ka", "--inception_path",
                     judge["path"], "--real_stat_path", stats, "--times", "2",
                     "--eval_batch_size", "3", teacher=world.jax_g)

    got = entry.profile_main(argv("port"), device="cpu")
    want = jax_profile_distill(_jax_profile_opt(argv("jax")))
    with open(tmp_path / "port" / "log.txt") as f:
        log = f.read()
    assert "mean pruning time over 10 runs" in log and "torch FLOP counter" in log
    assert (got["student_macs"], got["student_params"]) == (want["student_macs"],
                                                            want["student_params"])
    # the flop counter counts the convolutions' multiply-adds only; the
    # analytic count adds the norms and biases
    assert 0.8 * 2 * got["student_macs"] <= got["counted_flops"] <= 2 * got["student_macs"]
    assert got["latency_ms"] > 0 and got["pruning_seconds_mean"] > 0
    assert got["metrics"].keys() == want["metrics"].keys() == {
        "metric/fid", "metric/fid-mean", "metric/fid-best"}
    assert got["metrics"]["metric/fid"] == pytest.approx(want["metrics"]["metric/fid"],
                                                         rel=FID_RTOL)
    dumps = {who: {cat: sorted(os.listdir(tmp_path / who / "eval" / "latest" / cat))
                   for cat in ("input", "Sfake", "Tfake")} for who in ("port", "jax")}
    assert dumps["port"] == dumps["jax"]
    assert dumps["port"]["Sfake"] == [f"{i}.png" for i in range(4)]
    assert os.path.exists(tmp_path / "port" / "eval" / "latest" / "index.html")


def _jax_profile_opt(argv):
    import argparse

    import cat_tpu.cli as jcli

    p = argparse.ArgumentParser()
    jcli.base_arguments(p)
    jcli.distill_arguments(p)
    jcli.test_arguments(p)
    return p.parse_args(argv)


def test_kid_verb_matches_the_jax_package(world, judge, tmp_path, monkeypatch,  # noqa: F811
                                         capsys):
    """The KID tool over two folders (the fakes resized to the reals' size)
    against the JAX package's ``tools/kid_score.py``: the same printed
    subsets' mean and spread within 1e-3 relative of the kernel's scale.
    Four images a side, so each subset (of min(100, 4, 4)) is a permutation
    of both sets and the unseeded subset draws do not change the score."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
    try:
        import kid_score as jax_kid
    finally:
        sys.path.pop(0)
    rs = np.random.RandomState(8)
    fake = tmp_path / "fake"
    os.makedirs(fake)
    for i in range(4):
        Image.fromarray(rs.randint(0, 256, (24, 30, 3), dtype=np.uint8)).save(fake / f"{i}.png")
    argv = ["--real", os.path.join(world.data, "valB"), "--fake", str(fake), "--inception_path",
            judge["path"], "--batch_size", "3", "--n_subsets", "6"]
    mean, std = entry.kid_score_main(argv, device="cpu")
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["kid_score.py"] + argv)
    jax_kid.main()
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    jm, js = (float(t) for t in jax_line.split()[1::2][:2])
    assert port_line.startswith("KID: ") and jax_line.startswith("KID: ")
    scale = max(abs(jm), js, 1e-6)
    assert abs(mean - jm) <= 1e-3 * scale + 1e-6 and abs(std - js) <= 1e-3 * scale + 1e-6
    m2, s2, var = entry.kid_score_main(argv + ["--ret_var"], device="cpu")
    assert m2 == pytest.approx(mean, rel=1e-9) and var.shape == (6,)
