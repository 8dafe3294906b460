"""Serving and BMUF training over several processes on the CPU:

  * `BatchedPipeline(mesh=)` at dp=2 (two gloo ranks, one spawn; bodies in
    tests/_torch_bmuf_child.py) against the port's one-device pipeline on
    the same inputs with the same generator seed, which
    tests/test_torch_serving.py holds against the JAX package: sampled
    decodes that stop on EOS mid-chunk (rank 0's rows are done before rank
    1's, so it must step on) and at max_length, and the speculative decode;
    tokens, lengths and num_steps equal row for row, the generator's next
    draw equal, the wav within WAV_ATOL (f32; a rank runs its GEMMs at half
    the rows) and bit-equal on both ranks after the gather; and
    `serve_batch.serve` over the same two ranks (rank 0 writing) against
    the one-process command;
  * `serve_batch --multihost --device cpu` in two processes with torchrun's
    environment: each serves its rank-strided share of three scripts, and
    its wavs equal a one-process run over that share;
  * the train CLI's `--dp 2 --bmuf_sync 2 --bmuf_warmup 1` on tiny random
    VoMix files: the stacked state.npz (every array [2, ...]; the rows
    bit-equal after the syncs at steps 1-2, apart after the local step 3),
    `ema_canonical.npz` (rank 0's EMA) loading into `acoustic.sample`, a
    resume at the same dp continuing at step 4 (a sync), a resume in
    another layout raising ValueError naming both, and JAX's exits."""

import dataclasses
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from covomix_tpu_torch import serve_batch
from covomix_tpu_torch.checkpoint import io as pio
from covomix_tpu_torch.models import acoustic as PA, text2semantic as PT, vocoder as PV
from covomix_tpu_torch.parallel import multihost as MH
from covomix_tpu_torch.pipeline import load_checkpoint
from covomix_tpu_torch.train import cli
from covomix_tpu_torch.util.misc import tree_map

import _torch_bmuf_child
from _torch_port import P_AC, P_VOC
from test_torch_dp_cli import CLUSTER_VARS, REPO, _argv, _steps, _write_items
from test_torch_serve_batch import _assets
from test_torch_tp_cli import _state

DP = 2
WAV_ATOL = 1e-5      # the flow's 32 evaluations and the vocoder at f32, GEMMs at other row counts: ~1e-7 seen
T2S = PT.T2SConfig(dim=48, source_depth=1, target_depth=2, heads=2, dim_head=16, num_text_tokens=40,
                   num_semantic_tokens=12, target_dim=64, two_output=True, target_early_exit_layer=1)
EOS = T2S.semantic_eos_id


def _case(seed, top_k_thres, speculative=False):
    """Tiny CoMix T2S (its logits softened and the EOS row tied to token 3's,
    so rows end at different steps), VoMix and vocoder models from `seed`,
    B=4 inputs with mixed prompt lengths, decode 24."""
    g = torch.Generator().manual_seed(seed)
    t2s, ac, voc = PT.init(g, T2S), PA.init(g, P_AC), PV.init_generator(g, P_VOC)
    w = t2s["sem_emb"]["w"]
    with torch.no_grad():
        w.mul_(0.3)
        w[EOS] = 1.05 * w[3]
    rs = np.random.RandomState(seed)
    b, p = 4, 8
    inputs = (rs.randint(1, 40, (b, 6)).astype(np.int32), rs.randint(0, 500, (b, p, 2)).astype(np.int32),
              (rs.randn(b, p, 160) * 0.1).astype(np.float32), np.array([8, 3, 6, 5], np.int32))
    numpy = lambda tree: tree_map(lambda t: t.numpy(), tree)
    return {"t2s": numpy(t2s), "ac": numpy(ac), "voc": numpy(voc), "t2s_cfg": dataclasses.asdict(T2S),
            "ac_cfg": dataclasses.asdict(P_AC), "voc_cfg": dataclasses.asdict(P_VOC), "inputs": inputs,
            "decode": 24, "top_k_thres": top_k_thres, "speculative": speculative, "seed": seed}


CASES = {"eos_mid_chunk": _case(4, 0.3), "max_length": _case(4, 1.0), "speculative": _case(3, 0.1, True)}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    path = tmp_path_factory.mktemp("serving_dp")
    assets = tmp_path_factory.mktemp("serve_batch_dp")
    argv = _three_scripts(assets)
    dp_argv = list(argv)
    dp_argv[dp_argv.index("--saved_dir") + 1] = str(assets / "out_dp")
    with open(os.path.join(path, "inputs.pkl"), "wb") as f:
        pickle.dump({"dp": DP, "cases": CASES, "serve_batch": dp_argv}, f)
    MH.spawn(_torch_bmuf_child.serving_rank, DP, str(path), device="cpu", timeout=_torch_bmuf_child.TIMEOUT_S)
    ranks = []
    for r in range(DP):
        with open(os.path.join(path, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    serve_batch.main(argv)
    return {"ranks": ranks, "one": {name: _torch_bmuf_child.serve(case) for name, case in CASES.items()},
            "assets": assets}


@pytest.mark.parametrize("name", list(CASES))
def test_dp_pipeline_gives_the_one_device_rows(served, name):
    ref = served["one"][name]
    if name == "eos_mid_chunk":     # the global stop falls inside a chunk of 8, after rank 0's rows are done
        assert ref["num_steps"] == 6 and min(ref["lengths2"][:2]) < 6 and max(ref["lengths2"][2:]) == 6
    if name == "max_length":
        assert ref["num_steps"] == 24
    for res in served["ranks"]:
        got = res[name]
        for k in ("tokens", "tokens2", "lengths", "lengths2", "next_draw"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{name} rank {res['rank']} {k}")
        assert got["num_steps"] == ref["num_steps"]
        assert got["wav"].shape == ref["wav"].shape and np.isfinite(got["wav"]).all()
        np.testing.assert_allclose(got["wav"], ref["wav"], rtol=0, atol=WAV_ATOL)
    np.testing.assert_array_equal(served["ranks"][0][name]["wav"], served["ranks"][1][name]["wav"])


def test_serve_batch_over_dp_ranks_writes_rank0s_wavs(served):
    """serve_batch's serving over a dp=2 mesh (what `--batch 2` on two cards
    spawns: a row a rank, rank 0 writing): every wav of the one-process run,
    within one int16 step (f32, the rows at half the batch)."""
    out, ref = served["assets"] / "out_dp", served["assets"] / "out"
    assert sorted(os.listdir(out)) == sorted(os.listdir(ref)) == ["a.wav", "b.wav", "c.wav"]
    for name in os.listdir(ref):
        got, want = wavfile.read(str(out / name))[1], wavfile.read(str(ref / name))[1]
        assert got.shape == want.shape and len(want) > 0
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1, name


def _three_scripts(tmp_path):
    """_assets' checkpoints and script 'a', plus scripts 'b' and 'c' (own
    prompts); returns the CLI's arguments."""
    argv = _assets(tmp_path)
    rs = np.random.RandomState(3)
    for s, text in (("b", "good night [spkchange] see you"), ("c", "how are you [spkchange] fine")):
        (tmp_path / "text" / f"{s}.txt").write_text(text)
        for spk in (1, 2):
            base = tmp_path / "prompt" / f"{s}_{spk}"
            np.save(f"{base}.hubert_code.npy", rs.randint(0, 500, 12))
            np.save(f"{base}.mel.npy", rs.randn(80, 9 + spk).astype(np.float32))
    return argv


def _popen_all(cmds):
    """Run {name: (argv, env)} at once; their stdout by name (each must exit 0)."""
    procs = {k: subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for k, (c, env) in cmds.items()}
    try:
        out = {k: p.communicate(timeout=600) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for k, p in procs.items():
        assert p.returncode == 0, f"{k}: rc {p.returncode}\n{out[k][1][-2500:]}"
    return {k: v[0] for k, v in out.items()}


BMUF_FLAGS = ["--dp", "2", "--bmuf_sync", "2", "--bmuf_warmup", "1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """At once: the train CLI under --bmuf_sync (3 steps) and serve_batch
    --multihost in two processes; then the CLI's resume for one step."""
    root = tmp_path_factory.mktemp("bmuf_cli")
    data, logs, serving = root / "data", root / "logs", root / "serving"
    _write_items(data)
    serving.mkdir()
    argv = _three_scripts(serving)
    env = {k: v for k, v in os.environ.items() if k not in CLUSTER_VARS and not k.startswith("SLURM_")}
    env["OMP_NUM_THREADS"] = "1"
    mh = list(argv)
    mh[mh.index("--saved_dir") + 1] = str(serving / "out_mh")
    cluster = dict(env, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(MH.free_port()), WORLD_SIZE="2")
    out = _popen_all({"bmuf": (_argv(data, logs, "bmuf", *BMUF_FLAGS), env),
                      **{f"mh{r}": ([sys.executable, "-m", "covomix_tpu_torch.serve_batch", *mh, "--multihost"],
                                    dict(cluster, RANK=str(r), LOCAL_RANK=str(r))) for r in range(2)}})
    shutil.copytree(logs / "bmuf", logs / "bmuf_resume")
    out.update(_popen_all({"bmuf_resume": (_argv(data, logs, "bmuf_resume", *BMUF_FLAGS, "--max_steps", "4",
                                                 "--num_eval_files", "0",
                                                 "--resume"), env)}))
    return {"data": data, "logs": logs, "serving": serving, "argv": argv, "out": out}


def test_serve_batch_multihost_serves_each_process_share(runs):
    out, tmp_path, argv = runs["out"], runs["serving"], runs["argv"]
    assert "process 0/2: 2 scripts" in out["mh0"] and "process 1/2: 1 scripts" in out["mh1"]
    assert sorted(os.listdir(tmp_path / "out_mh")) == ["a.wav", "b.wav", "c.wav"]
    for r, share in ((0, ("a", "c")), (1, ("b",))):        # scripts[rank::2] of the sorted a, b, c
        text = tmp_path / f"text{r}"
        text.mkdir()
        for s in share:
            shutil.copy(tmp_path / "text" / f"{s}.txt", text / f"{s}.txt")
        one = list(argv)
        one[one.index("--text_dir") + 1] = str(text)
        one[one.index("--saved_dir") + 1] = str(tmp_path / f"out{r}")
        serve_batch.main(one)
        for s in share:
            ref = wavfile.read(str(tmp_path / f"out{r}" / f"{s}.wav"))[1]
            got = wavfile.read(str(tmp_path / "out_mh" / f"{s}.wav"))[1]
            assert len(ref) > 0
            np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# the train CLI under --bmuf_sync


def test_bmuf_cli_writes_the_stacked_state(runs):
    steps = _steps(runs["out"]["bmuf"])
    assert [r["step"] for r in steps] == [1, 2, 3] and all(np.isfinite(r["train_loss"]) for r in steps)
    ckpt = runs["logs"] / "bmuf" / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["ema_canonical.npz", "ema_canonical.npz.json", "step_00000002",
                                        "step_00000003", "topk.json"]
    for step, synced in ((2, True), (3, False)):
        state = _state(runs["logs"], "bmuf", step)
        assert state["bmuf/t"].tolist() == [step, step] and state["step"].tolist() == [step, step]
        assert state["params/to_embed/w"].shape[0] == 2 and state["bmuf/global/to_embed/w"].shape[0] == 2
        params = {k: v for k, v in state.items() if k.startswith("params/")}
        assert all(np.array_equal(v[0], v[1]) for v in params.values()) == synced
        # the global model is the last sync's: the parameters at step 2, both ranks'
        np.testing.assert_array_equal(state["bmuf/global/to_embed/w"][1], _state(
            runs["logs"], "bmuf", 2)["params/to_embed/w"][0])
    # Adam was reset at the warmup step: 2 updates since, on both ranks
    assert _state(runs["logs"], "bmuf", 3)["adam_step"].tolist() == [2, 2]


def test_bmuf_ema_canonical_is_rank0_and_samples(runs):
    ckpt = runs["logs"] / "bmuf" / "checkpoints"
    params, cfg = load_checkpoint(str(ckpt / "ema_canonical.npz"), PA.AcousticConfig)
    state = _state(runs["logs"], "bmuf", 3)
    np.testing.assert_array_equal(params["to_embed"]["w"], state["ema_params/to_embed/w"][0])
    rs = np.random.RandomState(3)
    y = PA.sample(pio.params_from_numpy(params, "cpu"), cfg, torch.Generator().manual_seed(0),
                  torch.from_numpy(rs.randint(0, 500, (1, 24, 2))),
                  torch.from_numpy(rs.randn(1, 24, 160).astype(np.float32)), step_size=0.25)
    assert y.shape == (1, 24, 80) and bool(torch.isfinite(y).all())


def test_bmuf_cli_resumes_at_the_same_dp(runs):
    out = runs["out"]["bmuf_resume"]
    assert "resumed from step 3" in out and [r["step"] for r in _steps(out)] == [4]
    state = _state(runs["logs"], "bmuf_resume", 4)
    assert state["bmuf/t"].tolist() == [4, 4] and state["adam_step"].tolist() == [3, 3]
    assert all(np.array_equal(v[0], v[1]) for k, v in state.items() if k.startswith("params/"))   # a sync


@pytest.mark.parametrize("flags,said", [
    (["--dp", "1"], r"BMUF stacked \{'train', 'bmuf'\} layout of dp=2.*canonical layout"),
    (["--dp", "1", "--bmuf_sync", "2"], r"layout of dp=2.*layout of dp=1"),
])
def test_bmuf_checkpoint_resumes_only_in_its_layout(runs, tmp_path, flags, said):
    logs = tmp_path / "logs"
    shutil.copytree(runs["logs"] / "bmuf", logs / "bmuf")
    argv = _argv(runs["data"], logs, "bmuf", *flags, "--resume", "--max_steps", "4")[3:]
    with pytest.raises(ValueError, match=said):
        cli.main(argv)


@pytest.mark.parametrize("flags,said", [
    (["--bmuf_sync", "2", "--grad_accum", "2"], "--grad_accum composes with single-host"),
    (["--bmuf_sync", "2", "--steps_per_dispatch", "2"], "--steps_per_dispatch composes with single-host"),
    (["--bmuf_sync", "2", "--dp", "2", "--batch_size", "3"], "--batch_size 3 must divide by dp=2 for --bmuf_sync"),
    (["--bmuf_sync", "2", "--multihost"], "--bmuf_sync is the pure-dp local-steps mode"),
])
def test_bmuf_jax_exits(tmp_path, flags, said):
    with pytest.raises(SystemExit, match=said):
        cli.main(["--base_dir", str(tmp_path), "--device", "cpu", *flags])
