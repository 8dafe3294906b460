"""The port's data-parallel GAN step (`train.gan.make_gan_step(mesh=)`)
against the JAX package's dp mesh step (tests/test_gan_dp.py's), on the
CPU: one state (a tiny generator, initial channel 16; the MPD / MSD at full
width), segment 1600, a global batch of 2, one row on each of two ranks
over gloo (`multihost.spawn`, tests/_torch_dp_child.py); JAX's step on a
2-device mesh with the state replicated and the batch over 'dp'.

D's gradients are averaged over the ranks before D's update and G's before
G's; the losses are element means, so the ranks' mean is the global loss.
mel_loss_weight 0, as tests/test_torch_gan_step.py runs the step (the
mel-L1 gradient of a random generator is ill-conditioned). Tolerances as
there: the losses to 1e-5 relative; after one update every element within
2 lr (the most two first AdamW updates can differ by) and all but 0.1 %
within 1e-6; the spectral buffers within 1e-5; the two ranks' state bit for
bit."""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.audio.mel import MelConfig as JMel
from covomix_tpu.parallel.mesh import make_mesh as jax_mesh, replicated, shard_tree
from covomix_tpu.train import gan as JG
from covomix_tpu_torch.parallel import multihost as MH
from covomix_tpu_torch.train import gan as PG
from covomix_tpu_torch.util.misc import named_leaves

import _torch_dp_child
from _torch_port import J_VOC, P_VOC, jax_gan_state, numpy_tree

SEG = 1600
KW = dict(segment_size=SEG, steps_per_epoch=1, mel_loss_weight=0.0)
LOSS_RTOL = 1e-5
STEP_ATOL, STEP_TIGHT, STEP_TIGHT_SHARE = 2 * 2e-4, 1e-6, 1e-3


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gan_dp"))
    st = PG.init_gan_state(torch.Generator().manual_seed(0), P_VOC, PG.GanConfig(segment_size=SEG))
    trees = numpy_tree(st.gen_params), numpy_tree(st.mpd_params), numpy_tree(st.msd_params)
    audio = (np.random.RandomState(3).randn(2, SEG) * 0.1).astype(np.float32)

    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg_j = JG.GanConfig(**KW)
    mesh = jax_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    state = jax_gan_state(*trees, cfg_j)
    state = shard_tree(state, replicated(mesh, state))
    step = JG.make_gan_step(J_VOC, JMel(), JMel(), cfg_j, mesh=mesh)
    js, jm = step(state, {"audio": jax.device_put(jnp.asarray(audio), NamedSharding(mesh, P("dp")))})
    js = jax.device_get(js)
    with open(os.path.join(path, "inputs.pkl"), "wb") as f:
        pickle.dump({"gen": trees[0], "mpd": trees[1], "msd": trees[2], "audio": audio, "gan_cfg": KW,
                     "voc_cfg": dataclasses.asdict(P_VOC)}, f)
    MH.spawn(_torch_dp_child.gan_step, 2, path, device="cpu")
    ranks = []
    for r in range(2):
        with open(os.path.join(path, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    ref = {"gen": dict(named_leaves(js.gen_params)),
           "d": dict(named_leaves({"mpd": js.mpd_params, "msd": js.msd_params}))}
    return {"jm": {k: float(v) for k, v in jm.items()}, "ref": ref, "ranks": ranks}


def test_losses_match_jax_mesh_step(run):
    for res in run["ranks"]:
        assert res["syncs"] == 2         # D's all-reduce, then G's
        assert res["metrics"].keys() == run["jm"].keys()
        for k, v in run["jm"].items():   # mel_error is 0 / 0 at mel_loss_weight 0 on both sides
            np.testing.assert_allclose(res["metrics"][k], v, rtol=LOSS_RTOL, equal_nan=True, err_msg=k)


@pytest.mark.parametrize("side", ["gen", "d"])
def test_updated_params_match_jax_mesh_step(run, side):
    """Every leaf after the step (the spectral buffers after their one power
    iteration among them)."""
    ref = run["ref"][side]
    got = run["ranks"][0][side]
    assert got.keys() == ref.keys()
    far = total = 0
    for name, p in got.items():
        buffer = name.startswith("msd/discriminators/0/") and name.endswith(("/u", "/v"))
        np.testing.assert_allclose(p, ref[name], rtol=1e-5 if buffer else 0, atol=1e-6 if buffer else STEP_ATOL,
                                   err_msg=name)
        far += int(np.sum(np.abs(p - ref[name]) > STEP_TIGHT))
        total += p.size
    assert far <= STEP_TIGHT_SHARE * total, (far, total)


def test_ranks_end_bit_equal(run):
    """Both ranks hold the same state after the step: parameters, and MSD[0]'s
    spectral buffers, whose power iteration ran on replicated weights."""
    a, b = run["ranks"]
    np.testing.assert_equal(a["metrics"], b["metrics"])     # mel_error: nan on both
    for side in ("gen", "d"):
        for name, p in a[side].items():
            np.testing.assert_array_equal(p, b[side][name], err_msg=name)
    assert any(n.endswith("discriminators/0/conv_post/u") for n in a["d"])
