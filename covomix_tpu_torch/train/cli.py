"""Training CLI of the port: `python -m covomix_tpu_torch.train ...`.

The flags of the JAX package's train.py plus `--device` (default cuda; bf16
compute with `--bf16`). It trains the acoustic model (VoSingle / VoMix) or,
with `--text2semantic`, the T2S model (CoSingle / CoMix; the tokenizer from
`--bert_vocab`, refusing the char-level fallback vocab unless
`--allow_fallback_vocab`) on one device: the step loop, logging cadence, eval
cadence with the EMA parameters (`evaluate_acoustic`, or `evaluate_t2s`'s
token WER), and the top-10-on-'l2' checkpoints follow train.py.

Parallel training runs one process per device (parallel/) on a `dp x tp`,
`dp x pp` or `dp x sp` mesh: `--dp N --tp M` (dp 0 = every visible device
over the second axis; the CPU counts as many as the flags ask) starts N x M
ranks from this one command, each running the same global loader and
keeping the rows of its dp index, so the run trains on the data of `--dp
1`; `--batch_size` is the global batch. `--tp M` splits the matmul
weights, embeddings and time MLP over M ranks (the tensor-parallel forward
of the models' `tp=`), `--fsdp` also splits every parameter, its Adam
moments and EMA over dp (the whole tree gathered once a step), with JAX's
layout (`parallel/mesh.param_shardings`). `--pp M` trains the acoustic
model with the GPipe schedule over M stages (`--pp_microbatches`,
parallel/pipeline.py): the state keeps JAX's {'stacked', 'rest'} layout,
each stage its depth / M layers, and every checkpoint also writes
`ema_canonical.npz` (+ `.json`), the EMA in the canonical layout that the
generation CLIs load; evals run on that layout. `--sp M` splits the
sequence over M ranks (ring attention, parallel/ring.py), with `--fsdp`
the parameters over dp as well. As in JAX, `--tp` has no effect under
`--pp` / `--sp` and `--fsdp` none under `--pp` (a note says so).
`--coordinator_address host:port --num_processes P --process_id I`, or
`--multihost` with torchrun's or SLURM's environment, joins a process group
instead: each process loads its dp index's rank-strided share of the files
(`ProcessShardDataset`) and `batch_size / dp` rows, padded to the ranks'
common shape (`reconcile_batch`). Rank 0 alone writes logs, evals and
checkpoints; a split state is gathered first (every rank takes part), so
a checkpoint holds the whole state and a run of any dp / tp / sp mesh or
of one device resumes from it. Under `--pp` the whole state is the
{'stacked', 'rest'} tree, as in JAX: a `--pp` checkpoint resumes only
under `--pp` and a canonical one only without it (any other resume raises
ValueError naming both layouts); `ema_canonical.npz` is the canonical EMA
for generation. `--dp N --bmuf_sync K [--bmuf_warmup W] [--bmuf_momentum
m]` trains with BMUF (parallel/bmuf.py, both recipes): N ranks each take
local optimizer steps on their rows with their own draws and no gradient
all-reduce, and sync their models every K steps (rank 0's model at step W;
the block momentum defaults to 1 - 1/N); the logged loss and grad norm are
the means over the ranks. Its checkpoints hold every rank's state in JAX's
stacked layout (a leading [N] axis; a resume restores each rank's row, and
resumes only under --bmuf_sync at the same N), beside `ema_canonical.npz`,
rank 0's EMA, on which evals run. `--steps_per_dispatch K` runs K optimizer
steps per call (`train.loop.make_multi_step`: on CUDA one captured CUDA
graph; `parallel.train_step.make_sharded_multi_step` under --dp / --tp /
--fsdp) over K loader batches stacked (each itself a --grad_accum stack),
as JAX's train.py: the loop advances K steps at a time, so a run may
overshoot --max_steps to a whole dispatch, and it logs the dispatch's last
step, saves and evaluates when a multiple of the cadence falls inside the
dispatch (JAX's `crossed`); a resume starts at the saved dispatch boundary.
JAX's refusals stand: `--pp` / `--sp` with `--text2semantic`, both at once,
or with `--grad_accum` / `--steps_per_dispatch` above 1; `--bmuf_sync`
with any other parallel flag, with either of those two above 1, or with a
batch that dp does not divide; `--fsdp`, `--grad_accum` or
`--steps_per_dispatch` above 1 in a multi-process group."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import torch
import torch.distributed

from covomix_tpu_torch import resolve_device
from covomix_tpu_torch.checkpoint import io as cio
from covomix_tpu_torch.data.datasets import (CoVoMixDataset, collate_acoustic, collate_t2s, data_loader,
                                             stack_microbatches)
from covomix_tpu_torch.data.tokenizer import load_covomix_tokenizer
from covomix_tpu_torch.models import acoustic as A, text2semantic as T
from covomix_tpu_torch.parallel import bmuf as BM, multihost as MH, pipeline as PP, train_step as TS
from covomix_tpu_torch.parallel.mesh import Mesh, is_sharded, make_mesh, process_group_ready, replicate
from covomix_tpu_torch.train import evaluate as E, loop
from covomix_tpu_torch.util.logging_utils import MetricsLogger
from covomix_tpu_torch.util.misc import tree_leaves
from covomix_tpu_torch.util.watchdog import Watchdog

def build_argparser():
    p = argparse.ArgumentParser(prog="python -m covomix_tpu_torch.train")
    t = p.add_argument_group("Trainer")
    t.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    t.add_argument("--log_dir", type=str, default="./logs")
    t.add_argument("--run_name", type=str, default=None)
    t.add_argument("--max_epochs", type=int, default=500)
    t.add_argument("--steps_per_epoch", type=int, default=0, help="0 = full dataset pass")
    t.add_argument("--dp", type=int, default=0, help="data-parallel ranks, one process each (0 = every device)")
    t.add_argument("--tp", type=int, default=1)
    t.add_argument("--pp", type=int, default=1)
    t.add_argument("--pp_microbatches", type=int, default=4)
    t.add_argument("--grad_accum", type=int, default=1,
                   help="micro-batches accumulated per optimizer step (mean); --batch_size is the micro-batch")
    t.add_argument("--steps_per_dispatch", type=int, default=1)
    t.add_argument("--sp", type=int, default=1)
    t.add_argument("--fsdp", action="store_true")
    t.add_argument("--bmuf_sync", type=int, default=0)
    t.add_argument("--bmuf_warmup", type=int, default=0)
    t.add_argument("--bmuf_momentum", type=float, default=None)
    t.add_argument("--bf16", action="store_true")
    t.add_argument("--ckpt_every", type=int, default=1000)
    t.add_argument("--eval_every", type=int, default=1000)
    t.add_argument("--num_eval_files", type=int, default=20)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--no_wandb", action="store_true", help="disable the W&B sink (JSONL+TensorBoard always on)")
    t.add_argument("--max_steps", type=int, default=0, help="stop after N steps (0 = unlimited)")
    t.add_argument("--log_every", type=int, default=50)
    t.add_argument("--multihost", action="store_true")
    t.add_argument("--coordinator_address", type=str, default=None)
    t.add_argument("--num_processes", type=int, default=None)
    t.add_argument("--process_id", type=int, default=None)
    m = p.add_argument_group("CoVoMixModel")
    m.add_argument("--lr", type=float, default=1e-4)
    m.add_argument("--ema_decay", type=float, default=0.999)
    m.add_argument("--CoVoMix_dim", type=int, default=80)
    m.add_argument("--CoVoMix_num_phoneme_tokens", type=int, default=502)
    m.add_argument("--CoVoMix_depth", type=int, default=8)
    m.add_argument("--CoVoMix_dim_head", type=int, default=64)
    m.add_argument("--CoVoMix_heads", type=int, default=16)
    m.add_argument("--CoVoMix_dim_transformer", type=int, default=1024)
    m.add_argument("--cond_drop_prob", type=float, default=0.0)
    m.add_argument("--lr_scheduler", action="store_true")
    m.add_argument("--total_epochs", type=int, default=500)
    m.add_argument("--wake_up_epochs", type=int, default=15)
    m.add_argument("--decay_start_epoch", type=int, default=30)
    m.add_argument("--text2semantic", action="store_true")
    m.add_argument("--twocondition_twooutput", action="store_true")
    m.add_argument("--twocondition_oneoutput", action="store_true")
    m.add_argument("--text2semantic_tokens", type=int, default=501)
    m.add_argument("--text2semantic_target_depth", type=int, default=4)
    m.add_argument("--text2semantic_source_depth", type=int, default=4)
    m.add_argument("--text2semantic_head", type=int, default=8)
    m.add_argument("--no_source_transformer", action="store_true")
    m.add_argument("--text2semantic_two_output", action="store_true")
    m.add_argument("--num_text_token_ids", type=int, default=30528)
    m.add_argument("--target_transformer_dim", type=int, default=0)
    d = p.add_argument_group("DataModule")
    d.add_argument("--base_dir", type=str, required=True)
    d.add_argument("--dev_base_dir", "--val_dir", type=str, default=None, dest="dev_base_dir",
                   help="held-out eval dir; default: every 10th file of --base_dir is held out")
    d.add_argument("--format", type=str, default="hubert_fisher")
    d.add_argument("--batch_size", type=int, default=8)
    d.add_argument("--num_workers", type=int, default=0)
    d.add_argument("--dummy", action="store_true")
    d.add_argument("--random_mask", action="store_true")
    d.add_argument("--bert_vocab", type=str, default=None)
    d.add_argument("--allow_fallback_vocab", action="store_true")
    d.add_argument("--seed", type=int, default=0)
    return p


_FSDP_MULTIHOST = ("--fsdp with --multihost needs an all-gather before host checkpointing (params are not "
                   "host-addressable); run multihost with replicated params (dp/tp) for now")


def _refuse_unported(args) -> None:
    if args.bmuf_sync > 0 and (args.tp > 1 or args.pp > 1 or args.sp > 1 or args.fsdp
                               or args.multihost or args.coordinator_address):
        sys.exit("--bmuf_sync is the pure-dp local-steps mode; it composes with none of "
                 "--tp/--pp/--sp/--fsdp/--multihost")
    staged = args.pp > 1 or args.sp > 1
    if staged and args.text2semantic:
        sys.exit("--pp/--sp apply to the acoustic model only")
    if args.pp > 1 and args.sp > 1:
        sys.exit("choose one of --pp / --sp")
    if args.grad_accum > 1 and (staged or args.bmuf_sync > 0):
        sys.exit("--grad_accum composes with single-host dp/tp/fsdp only (pp has its own microbatching; bmuf "
                 "accumulates via local steps)")
    if args.steps_per_dispatch > 1 and (staged or args.bmuf_sync > 0):
        sys.exit("--steps_per_dispatch composes with single-host dp/tp/fsdp only")


def _datasets(args):
    """(train, eval) datasets: --dev_base_dir, else every 10th file of
    --base_dir held out (training files when there are fewer than 10)."""
    dataset = CoVoMixDataset(args.base_dir, format=args.format, random_mask=args.random_mask,
                             dummy=args.dummy, seed=args.seed)
    if len(dataset) == 0:
        sys.exit(f"no training files found under {args.base_dir} for format={args.format}")
    if args.dev_base_dir:
        val = CoVoMixDataset(args.dev_base_dir, format=args.format, random_mask=args.random_mask,
                             shuffle_spec=False, seed=args.seed)
    elif len(dataset.files) >= 10:
        val_files = dataset.files[::10]
        dataset.files = [f for i, f in enumerate(dataset.files) if i % 10]
        dataset.short_files = [f for f in dataset.files
                               if not os.path.basename(f).endswith("_1.hubert_code.npy")] or dataset.files
        val = CoVoMixDataset(args.base_dir, format=args.format, random_mask=args.random_mask,
                             shuffle_spec=False, seed=args.seed, files=val_files)
    else:
        val = dataset
        print("note: <10 training files; eval scores training files", file=sys.stderr)
    if len(val) == 0:
        sys.exit(f"no eval files found under {args.dev_base_dir}")
    return dataset, val


def _notes(args) -> None:
    """JAX's pp / sp meshes have no tp axis, and its pp state no FSDP split."""
    if (args.pp > 1 or args.sp > 1) and args.tp > 1:
        print(f"note: --tp {args.tp} has no effect under --pp / --sp (their meshes are dp x pp and dp x sp)")
    if args.pp > 1 and args.fsdp:
        print("note: --fsdp has no effect under --pp (each stage holds its layers, the rest is replicated)")


def make_run_mesh(args, device) -> Mesh:
    """The mesh of the run's flags: dp x pp, dp x sp or dp x tp."""
    if args.pp > 1 or args.sp > 1:
        return make_mesh(args.dp, device, pp=args.pp, sp=args.sp)
    return make_mesh(args.dp, device, tp=args.tp)


def build_model(args, gen: torch.Generator, mesh: Optional[Mesh] = None):
    """(model config, parameters drawn from `gen` on its device, loss_fn)
    of the run's flags; `mesh`: the loss of one rank's rows (train_step);
    on a pp mesh the parameters in the pipeline's {'stacked', 'rest'}
    layout."""
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.text2semantic:
        model_cfg = T.T2SConfig(
            dim=args.CoVoMix_dim_transformer, source_depth=args.text2semantic_source_depth,
            target_depth=args.text2semantic_target_depth, heads=args.text2semantic_head,
            num_text_tokens=args.num_text_token_ids, num_semantic_tokens=args.text2semantic_tokens,
            target_dim=args.target_transformer_dim or args.CoVoMix_dim_transformer,
            two_output=args.text2semantic_two_output, no_source_transformer=args.no_source_transformer,
            cond_drop_prob=args.cond_drop_prob)
        return model_cfg, T.init(gen, model_cfg), loop.t2s_loss_fn(model_cfg, dtype=dtype, mesh=mesh)
    mode = "two_one" if args.twocondition_oneoutput else ("two_two" if args.twocondition_twooutput else "single")
    model_cfg = A.AcousticConfig(dim_in=args.CoVoMix_dim, dim=args.CoVoMix_dim_transformer,
                                 depth=args.CoVoMix_depth, dim_head=args.CoVoMix_dim_head,
                                 heads=args.CoVoMix_heads, num_phoneme_tokens=args.CoVoMix_num_phoneme_tokens,
                                 mode=mode)
    params = A.init(gen, model_cfg)
    if mesh is not None and mesh.pp > 1:
        params = dict(zip(("stacked", "rest"), PP.stack_layer_params(params, model_cfg)))
    return model_cfg, params, loop.acoustic_loss_fn(model_cfg, cond_drop_prob=args.cond_drop_prob, dtype=dtype,
                                                    mesh=mesh, num_microbatches=args.pp_microbatches)


def train_config(args, steps_per_epoch: int) -> loop.TrainConfig:
    return loop.TrainConfig(lr=args.lr, ema_decay=args.ema_decay, use_lr_schedule=args.lr_scheduler,
                            total_epochs=args.total_epochs, wake_up_epochs=args.wake_up_epochs,
                            decay_start_epoch=args.decay_start_epoch, steps_per_epoch=steps_per_epoch,
                            grad_accum=max(1, args.grad_accum))


def build_collate(args):
    """(collate, evaluate) of the run's model."""
    if args.text2semantic:
        # strict: a model trained on the fallback vocab's ids decodes garbage under the real one
        tok = load_covomix_tokenizer(args.bert_vocab, strict=not args.allow_fallback_vocab)
        return (lambda items: collate_t2s(items, tok)), E.evaluate_t2s
    return collate_acoustic, E.evaluate_acoustic


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    _refuse_unported(args)
    _notes(args)
    device = resolve_device(args.device)
    owned = False
    if args.multihost or args.coordinator_address is not None:
        # the rendezvous comes before the first allocation on the card
        owned = not process_group_ready() and MH.initialize(
            args.coordinator_address, args.num_processes, args.process_id, requested=True, device=device)
    if process_group_ready():
        try:
            if args.fsdp and torch.distributed.get_world_size() > 1:
                sys.exit(_FSDP_MULTIHOST)
            _train(args, make_run_mesh(args, device), per_process_data=True)
        finally:
            if owned:
                torch.distributed.destroy_process_group()
        return
    mesh = make_run_mesh(args, device)
    if args.bmuf_sync > 0 and args.batch_size % mesh.dp:
        sys.exit(f"--batch_size {args.batch_size} must divide by dp={mesh.dp} for --bmuf_sync")
    if mesh.dp * mesh.n > 1:
        MH.spawn(_rank_main, mesh.dp * mesh.n, args, device=device)
    else:
        _train(args, mesh)


def _rank_main(args) -> None:
    """One rank of a single-command `--dp N --tp / --pp / --sp M` run
    (multihost.spawn)."""
    _train(args, make_run_mesh(args, args.device), per_process_data=False)


def _train(args, mesh: Mesh, per_process_data: bool = False) -> None:
    """The run as rank `mesh.rank` of `mesh.dp x mesh.n`. In a process
    group the step averages the gradients over the dp ranks, the losses draw
    for the global batch, with --tp / --fsdp / --pp each rank holds its part
    of the state, and under --pp / --sp the ranks of a dp index add their
    shares of the gradient first; under --bmuf_sync each rank steps on its
    rows alone and the ranks sync their models every K steps.
    `per_process_data`: this process loads its dp index's share of the
    files and rows (the multi-process contract); otherwise every rank runs
    the global loader and keeps its rows."""
    primary = mesh.rank == 0
    device = mesh.device
    dp_mesh = mesh if mesh.collective else None
    run_name = args.run_name or f"{'t2s' if args.text2semantic else 'acoustic'}_{int(time.time())}"
    run_dir = os.path.join(args.log_dir, run_name)
    os.makedirs(run_dir, exist_ok=True)
    if primary:
        with open(os.path.join(run_dir, "args.txt"), "w") as f:
            json.dump(vars(args), f, indent=2)

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    gen = torch.Generator(device=device).manual_seed(args.seed)
    bmuf = args.bmuf_sync > 0     # each rank's loss is its own rows' (JAX's per_worker calls the plain loss)
    model_cfg, params, loss_fn = build_model(args, gen, None if bmuf else dp_mesh)

    dataset, val_dataset = _datasets(args)
    ga = max(1, args.grad_accum)
    if args.batch_size % mesh.dp:
        sys.exit(f"--batch_size {args.batch_size} must divide by {mesh.dp} processes")
    sharded_files = per_process_data and mesh.dp > 1
    if sharded_files and ga > 1:
        sys.exit("--grad_accum composes with single-host dp only (one process feeding every rank)")
    spd = max(1, args.steps_per_dispatch)
    if sharded_files and spd > 1:
        sys.exit("--steps_per_dispatch composes with single-host dp/tp/fsdp only")
    local_bs = args.batch_size // mesh.dp if sharded_files else args.batch_size
    if sharded_files:
        dataset = MH.ProcessShardDataset(dataset, mesh=mesh)
    steps_per_epoch = args.steps_per_epoch or max(1, len(dataset) // (local_bs * ga))
    collate, evaluate = build_collate(args)
    loader = data_loader(dataset, local_bs, collate, seed=args.seed, num_workers=args.num_workers)
    train_cfg = train_config(args, steps_per_epoch)
    specs = None        # the parts' layout, when the state is split over the ranks
    if bmuf:
        replicate(mesh, tree_leaves(params))
        state = loop.init_train_state(params, train_cfg)
        bcfg = BM.BMUFConfig(sync_every=args.bmuf_sync, warmup_steps=args.bmuf_warmup,
                             block_momentum=args.bmuf_momentum)
        bmuf_state = BM.init_bmuf_state(state.params)
        step_fn = BM.make_bmuf_train_step(loss_fn, train_cfg, bcfg, mesh, bmuf_state)
        gen = BM.rank_generator(device, args.seed, mesh.dp_rank)
    elif dp_mesh is None:
        state = loop.init_train_state(params, train_cfg)
        step_fn = loop.make_multi_step(loss_fn, train_cfg, spd)
    else:
        state, specs = TS.init_sharded_state(params, train_cfg, dp_mesh, tp=args.tp > 1, fsdp=args.fsdp)
        step_fn = TS.make_sharded_multi_step(loss_fn, train_cfg, dp_mesh, specs, spd)
        if not any(is_sharded(s) for s in specs.values()):
            specs = None

    def whole_state():
        """The full train state (every rank takes part when it is split or,
        under BMUF, stacked)."""
        if bmuf:
            return BM.stack_states(mesh, state, bmuf_state)
        return state if specs is None else TS.gather_state(dp_mesh, state, specs)

    stacked = dp_mesh is not None and dp_mesh.pp > 1

    def ema_tree(whole):
        """The EMA that evals run on and ema_canonical.npz holds, in the
        canonical layout: under --pp unstacked, under BMUF rank 0's own."""
        if bmuf:
            return state.ema_params
        ema = whole.ema_params
        return PP.unstack_layer_params(ema["stacked"], ema["rest"], model_cfg) if stacked else ema

    def save(whole, step, metric=None):
        ckpt_mgr.save(whole, step, metric=metric)
        if stacked or bmuf:      # the layout every generation CLI loads
            cio.save_params(os.path.join(ckpt_dir, "ema_canonical.npz"), ema_tree(whole),
                            meta={"step": step, "config": dataclasses.asdict(model_cfg)})

    ckpt_dir = os.path.join(run_dir, "checkpoints")
    ckpt_mgr = cio.TopKCheckpointer(ckpt_dir, top_k=10, mode="min")   # save_last + top-10 on 'l2'
    last_saved = ckpt_mgr.last_step
    start_step = 0
    if args.resume:
        latest = cio.latest_step(ckpt_dir)
        if latest is not None:
            if bmuf:        # each rank its own row of the stack
                cio.load_train_state(ckpt_dir, latest, state, bmuf=(bmuf_state, mesh.dp, mesh.dp_rank))
            elif specs is None:
                cio.load_train_state(ckpt_dir, latest, state)
                if dp_mesh is not None:
                    TS.replicate_state(dp_mesh, state)
            else:   # the full tree, then this rank's parts of it
                TS.load_shards(dp_mesh, state, cio.load_train_state(ckpt_dir, latest, whole_state()), specs)
            start_step = latest
            if primary:
                print(f"resumed from step {latest}", flush=True)

    # sinks on rank 0 only: every rank writing the run dir would duplicate them
    logger = MetricsLogger(run_dir, tensorboard=True, wandb=not args.no_wandb,
                           wandb_run=args.run_name) if primary else None
    total_steps = args.max_steps or args.max_epochs * steps_per_epoch
    t_last, step_last = time.time(), start_step
    done = start_step

    def crossed(done: int, every: int) -> bool:
        """JAX's rule: a multiple of `every` lies in (done - spd, done] (with
        one step a dispatch, done % every == 0)."""
        return every > 0 and done // every > (done - spd) // every

    def one_step_batch():
        return stack_microbatches([next(loader) for _ in range(ga)]) if ga > 1 else next(loader)

    with Watchdog(timeout_s=1800.0, name=run_name) as watchdog:
        try:
            for step_i in range(start_step, total_steps, spd):
                # [K(, A), b, ...] under --steps_per_dispatch: K step batches stacked
                batch = stack_microbatches([one_step_batch() for _ in range(spd)]) if spd > 1 else one_step_batch()
                if dp_mesh is not None:
                    batch = (MH.reconcile_batch(batch, device) if per_process_data
                             else TS.shard_batch(dp_mesh, batch, lead=(spd > 1) + (ga > 1)))
                metrics = step_fn(state, batch, gen)
                if spd > 1:     # the stacked [K] metrics -> the dispatch's last step
                    metrics = {k: v[-1] for k, v in metrics.items()}
                done = step_i + spd
                watchdog.beat(done)
                evaluating = args.num_eval_files and crossed(done, args.eval_every)
                saving = crossed(done, args.ckpt_every) or evaluating
                if evaluating:
                    # read on every rank: the items draw from the dataset's own random state, which
                    # the training items share when there are fewer than 10 files
                    items = [val_dataset[i % len(val_dataset)]
                             for i in range(min(args.num_eval_files, len(val_dataset)))]
                if saving:
                    last_saved = done
                whole = whole_state() if saving else None     # a split state gathered on every rank
                if not primary:
                    del whole           # not held through the next step (under FSDP it is the whole state)
                    continue
                if crossed(done, args.log_every):
                    now = time.time()
                    sps = (done - step_last) / max(now - t_last, 1e-9)
                    t_last, step_last = now, done
                    rec = {"epoch": done // steps_per_epoch, "train_loss": float(metrics["loss"]),
                           "grad_norm": float(metrics["grad_norm"]), "steps_per_sec": round(sps, 3)}
                    print(json.dumps({"step": done, **rec}), flush=True)
                    logger.log(done, rec)
                eval_metric = None
                if evaluating:
                    batches = [collate(items[i:i + args.batch_size]) for i in range(0, len(items), args.batch_size)]
                    # its own generator: the training draws stay in step across ranks, and
                    # an eval gives the same numbers in a resumed run as in an unbroken one
                    eval_gen = torch.Generator(device=device).manual_seed(args.seed + done)
                    ev = evaluate(ema_tree(whole), model_cfg, batches, eval_gen, dtype=dtype)
                    print("eval:", json.dumps(ev), flush=True)
                    logger.log(done, ev, prefix="eval_")
                    eval_metric = ev["l2"]
                if saving:
                    save(whole, done, eval_metric)
                del whole
        finally:
            if logger is not None:
                logger.close()
            if hasattr(loader, "close"):
                loader.close()
    final_step = max(total_steps, done)     # --steps_per_dispatch may overshoot by < K
    if last_saved != final_step:     # not saved just now (eval at the last step)
        whole = whole_state()
        if primary:
            save(whole, final_step)
    if primary:
        print(f"done: {final_step} steps -> {ckpt_dir}", flush=True)
