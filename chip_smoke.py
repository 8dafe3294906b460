#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout; needs one CUDA card
    python3 chip_smoke.py --ab-training DIR [CELLS [PAIRS]]  # the training cells (bf16, f32), DIR's tree
                                              # against this one (CELLS e.g. train,t2s; PAIRS default 10)
    python3 chip_smoke.py --vocoder           # the fused vocoder kernels alone
    python3 chip_smoke.py --flash-f32         # the f32 flash kernels at head dim 64 alone
    python3 chip_smoke.py --vocoder-split DIR # the fused kernels' time split, DIR's tree against this one
    python3 chip_smoke.py --bench             # phase 15 alone: the port's serving benchmark and its gates
    python3 chip_smoke.py --gan               # phase 16 alone: HiFi-GAN training at full width
    python3 chip_smoke.py --dp                # phase 17 alone: data-parallel training at full width
    python3 chip_smoke.py --tp                # phase 18 alone: tensor-parallel and FSDP training at full width
    python3 chip_smoke.py --pp                # phase 19's pipeline-parallel cells alone
    python3 chip_smoke.py --sp                # phase 19's sequence-parallel cells and sample_sp alone
    python3 chip_smoke.py --bmuf              # phase 20's BMUF training cells alone
    python3 chip_smoke.py --serve_dp          # phase 20's dialogue serving over dp alone
    python3 chip_smoke.py --data_prep         # phase 21's data preparation (mels, metrics, legacy helpers) alone
    python3 chip_smoke.py --eval_files        # phase 21's file-level evals and adaptive sampling alone
    python3 chip_smoke.py --multi_step        # phase 22 alone: K steps per dispatch, one captured CUDA graph
    python3 chip_smoke.py --single            # phase 23 alone: the CoVoSingle family (generation and training)

`--vocoder` is the quick loop for the fused stage / tail kernels: it builds
only their library, logs ptxas's registers and spills, runs check_vocoder's
cases, times both kernels at T=512 and at the per-file main path's shapes
([1,40964,125] stage, [1,163856,62] tail, bf16) and the 41 s
hifigan_inference file's ([1,42244,125] / [1,168976,62], f32), on seeded
random inputs with full-width weights, each timed output held against its
plain version and each launch's block plan logged, holds VOC_REGS, and ends
with the same `ok` line. `--flash-f32` does the same for the f32 forward
(flash_f32_mode: the forward at HuBERT's shape, and the forward with lse,
dQ and dK/dV at both training shapes). Neither replaces the default run.

Phases (any failure exits non-zero, nothing is passed over):
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the ported paths from the checkout's sources
     (nvcc, sm_90a) into covomix_tpu_torch/_build/: the flash kernels (non-
     causal and causal, the rotary pre-pass) for the head dim 64 and for the
     edge head dims checked below (one nvcc per head dim) and the fused
     vocoder stage/tail library (both dtypes), all started together; log
     ptxas's registers, spills and wgmma notes, and hold the dh-64 flash
     kernels to FLASH_REGS and the fused vocoder kernels to VOC_REGS, with
     no spills. Phases 16 and 9b, which need only the dh-64 flash and the
     vocoder libraries and are bound by the card, run first, while the edge
     head dims build;
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the paths give it and at edge shapes, with stated tolerances:
     the rotary pre-pass bit for bit against `_rotary_plain`; the inference
     forward; the training forms (forward with lse, dQ,
     dK/dV); their causal forms (the T2S decoder's: [6, 8, 1026, 64], odd
     and even T 513-2050, T under 512, valid_len [1] < T and [B], rotary off
     and on, head dims 16-256, also the causal forward without lse); with
     the rotary tables, dQ and dK bit for bit against `_rotary_transpose` of
     the kernels' untabled outputs and within tolerance of the plain
     versions with the tables; autograd through the kernels against
     autograd through the plain version, in both forms; the fused vocoder
     stage and tail;
  4. run batched dialogue serving at full width (CoMix T2S -> VoMix flow ->
     HiFi-GAN, bf16, B=4, prompt 400, decode 512) with random weights from a
     seed: one warm-up batch, then timed batches; the flash kernel's launch
     count over one batch must be 8 layers x 16 steps x 2 evals = 256, and
     as many rotary pre-passes;
  5. time the kernels at the paths' shapes beside their plain versions, and
     hold each timed output against its plain version on the same inputs.
     Each kernel's `ms` is CUDA events around calls issued back to back, as
     a path issues them (a call's host side shows where it outlasts the
     kernel); `device_ms` the same calls queued behind a sleep kernel (the
     card's time alone). The forward's entry is the attention kernel alone;
     with the rotary pre-pass, as the flow sampler calls it, it is logged as
     `ms_with_prepass`. The host microseconds per call of the forward's
     wrapper are logged at the serving shape;
  6. per-file generation: full-width random checkpoints written with the
     port's save_params, two dialogue scripts with 400-frame prompts, and
     `covomix_tpu_torch.dialogue_generation.main([... --mode covomix
     --fuse_tail --device cuda ...])` in-process; every vocode must launch the
     fused stage and tail once each, every flow sample the flash kernel and
     the rotary pre-pass 256 times, and every wav be finite int16 of 160 x generated frames; the
     fused kernels are then checked and timed on the very inputs the last
     vocode gave them, and the flash kernel at the flow sample's shape;
  7. check small f32 runs on the card against the same runs on the CPU, with
     greedy decode and shared noise: batched serving (the flash kernel's
     plain version on the CPU), and the Synthesizer's covomix dialogue with
     fuse_tail and a full-width vocoder (the unfused generator on the CPU);
  8. full-width VoMix training (the recipe of running_command/Acous_VoMix.sh,
     bf16, B=8, T=832) through `covomix_tpu_torch.train.cli.main` on random
     data: 12 optimizer steps, one eval on 8 dev files and its top-k save,
     then `--resume` for one more step; every step must launch the forward
     with lse, dQ, dK/dV and the rotary pre-pass 8 times each (and nothing
     else), the eval only the forward without lse and the pre-pass; then the step's forward / backward / optimizer
     split, the three training kernels timed at [8, 16, 832, 64] beside
     their plain versions, bounds and PyTorch yardsticks (dQ and dK/dV with
     the rotary tables, as the step calls them; the pair against one SDPA
     gradient call; the PyTorch re-rotation and counter-rotation that the
     tables replaced), and two f32 steps of a tiny model on the card against
     the CPU;
  9. full-width CoMix T2S training (running_command/T2S_CoMix.sh on one card,
     bf16, B=6, the tokenizer's fallback vocab) through
     `covomix_tpu_torch.train.cli.main` on 24 + 6 random items of 520-1000
     codes: 12 optimizer steps, one eval (a 512-step decode) on the 6 dev
     files and its top-k save, then `--resume` for one more step; every step
     must launch the causal forward with lse, causal dQ and causal dK/dV 4
     times each (the 4 decoder layers) and no other flash kernel (the encoder
     stays below 512 ids, on layers.attend), the eval none; then the step's
     split at decoder T 1026, the three causal kernels timed at
     [6, 8, 1026, 64] beside their plain versions, bounds and
     `scaled_dot_product_attention(is_causal=True)` and its gradient, and two
     f32 steps of a tiny CoMix T2S model on the card against the CPU;
  9b. full-width training at the recipes' own precision (f32, the recipes
     of phases 8 and 9 without --bf16) on the same random items: 8
     optimizer steps each, no eval, no resume; every VoMix step must launch
     exactly 8 f32 forwards with lse, 8 dQ and 8 dK/dV (the tiled f32
     kernels; the backward takes the rotary tables, no pre-pass), every T2S
     step 4 causal ones of each, nothing else; finite losses; the median ms
     per step, samples/s, the forward / backward / optimizer split and the
     peak memory. Phases 8 and 9 also time the f32 forms of the three
     kernels (time_flash_f32: [8, 16, 832, 64] with the tables, [6, 8,
     1026, 64] causal) beside their plain versions, their bounds at the f32
     peak, f32 SDPA and its gradient, and the `_unrotate` passes the tables
     replace; with the tables dq and dk bit for bit against
     `_rotary_transpose` of the untabled kernels';
 10. the released checkpoint formats (run after phase 7, on phase 6's
     full-width trees): Lightning `.ckpt` files (hyper_parameters, an EMA
     shadow) of the CoMix T2S and VoMix models and a weight-normed HiFi-GAN
     `g_<step>` + vocoder_config.json, written by tests/_torch_ckpt.py and
     converted back by `python -m covomix_tpu_torch.convert_checkpoint`
     (every leaf equal to its source: bit for bit, the folded vocoder within
     CKPT_WN_RTOL); then one `serve_batch --device cuda` batch at the
     serving shape read straight from the `.ckpt` / `g_` files (256 flash
     launches and pre-passes, finite wavs of the expected lengths);
 11. `hifigan_inference --device cuda` from the `g_` file over four 8 kHz
     wavs (3, 10.24, 20, 41 s), f32, with --metrics_csv, with and without
     --fuse_tail: per file one f32 fused stage and tail launch with it and
     none without, finite wavs of output_length(T), finite CSV values, the
     two runs' wavs within HIFI_FUSED_TOL outside the generator's reach from
     the valid end; then the f32 stage and tail timed (and held to their
     plain versions) on the inputs the 41 s file gave them;
 12. HuBERT: `extract_semantic_tokens --device cuda` at full width (random
     seeded weights written to `.npz`) over twelve 16 kHz wavs of 3-60 s, in
     f32 and with --bf16: per batch 12 non-causal forwards without lse when
     its padded frames are >= 512 and none below (both routes occur), no
     rotary pre-pass, no other flash kernel; string arrays of
     num_output_frames ids in [0, 500); tokens/s and x realtime; one padded
     batch at 2 encoder layers card vs CPU in f32 (features within
     HUBERT_FEAT_TOL, the share of equal ids printed); the forward at the
     largest flash batch's shape in f32 and bf16, held to its plain version
     and timed beside it, SDPA in the same dtype and its bound;
 13. speculative decode at full width (on phase 4's VoMix / HiFi-GAN and
     phase 6's assets): (a) fit the draft heads of the serving CoMix T2S
     with the early exit at layer 2 (`train.loop.make_train_step`,
     `t2s_loss_fn`, bf16, Adam 3e-4, B=8, 24-id texts, targets of 576
     codes: bench.py's positional pattern for 480, then EOS) for
     SPEC_FIT_STEPS = 200 steps: the first
     SPEC_FIT_EAGER = 8 one at a time, each launching exactly 4 causal
     forwards with lse, 4 causal dQ and 4 causal dK/dV and no other flash
     kernel, the first step's gradient on both draft heads; the rest as
     captured dispatches of SPEC_FIT_K = 8 steps
     (`make_multi_step`), each replay 8 steps' launches; finite losses
     throughout; (b) greedy `generate`
     against `generate_speculative` at gamma 2, 4, 8 on 8 texts, max_length
     512: tokens equal in f32 (TF32 off), in bf16 equal up to a near-tie
     (SPEC_BF16_TIE), at most tokens / 2 verify rounds; bf16 walls (one
     run each) and bench.py's t2s_spec_* keys; (c) BatchedPipeline(speculative=True,
     spec_gamma=4) at phase 4's shape: 256 flash forwards and pre-passes per
     batch, a finite wav, tokens a greedy decode's, the split beside phase
     4's; (d) `dialogue_generation --speculative` on phase 6's assets with
     the fitted T2S: phase 6's gates, tokens a greedy Synthesizer's;
 14. the one-program T2S decode (after phase 13, on phase 4's T2S and
     phase 13's fitted heads): `generate` as a captured CUDA graph against
     the same step called directly (text2semantic.CAPTURE off) at the
     serving shape (B=4, 512 steps, min_length 512, bf16 and f32) and the
     per-file shape (B=1, 2048 steps, bf16; both forms of the 2048-step
     program cut after its first PER_FILE_HELD steps, held, timed and
     traced there, the same captured program then timed over the whole
     decode), and
     greedy / speculative
     (gamma 2 / 4 / 8) at B=8 in bf16: tokens equal (f32 exactly, bf16 up
     to hold_tokens' near-tie), num_steps equal, the generator's next draw
     equal; walls best of DECODE_TURNS in turns, ms per step or round, host
     reads per call, each graph's capture time, peak memory, and
     `util.profiling`'s device idle share of each captured decode window
     (the direct windows are no longer traced, since PR 19; phase 4
     adds one serving batch's, phase 8 one bf16 VoMix step's). Phases 4, 6,
     7, 9 and 13 decode through the graphs too, with their gates unchanged;
 15. the port's serving benchmark, `covomix_tpu_torch.bench`, in-process
     with its defaults but BENCH_RUNS timed runs per B and a
     SPEC_FIT_STEPS draft fit (the JAX bench.py's measurement at full width:
     staged and one-call serving at B = 4, 16, 64, prompt 400, decode 512,
     bf16; vocoder and HuBERT throughput; a VoMix and a CoMix T2S training
     step; the draft heads fitted and speculative against greedy decode);
     its JSON line printed and held: every key the JAX bench prints,
     finite numbers, every MFU in (0, 1.05], 512 decoded steps at every B
     in both paths, the card's name, power limit, peak memory per B and
     idle share, and the launches per call of each part (256 forwards and
     pre-passes per flow sample, none in the one call's valid_len vocoder,
     one fused stage and tail per whole-mel generator call, 8 / 8 / 8 per
     VoMix step, 4 causal of each per T2S step, 12 per HuBERT batch, none
     in the decodes and the fit); then the fused stage and tail held to
     their plain versions and timed on the inputs the bench's staged mels
     give them at B = 4 (and held once more, untimed, at B = 64), one flow
     sample at B = 4 traced (the card's time by kernel: flash, GEMMs, the
     rest), and
     the flash forward held and timed at the flow's B=64 shape
     [128, 16, 912, 64];
 16. HiFi-GAN training at the covomix config's full width (batch 80,
     segment 8032, initial channel 500; GAN_CONFIG writes
     config_covomix.json) through `covomix_tpu_torch.hifigan_train.main`
     in-process on 32 seeded synthetic 8 kHz wavs of 2-12 s: f32 for 5
     steps (1 warm-up + 4 timed, the checkpoint and a validation at the
     last), `--resume`d for one step (the counters continue from 5), --bf16
     for 3 steps (1 + 2); every loss finite, MSD[0]'s spectral u / v of unit
     norm; the median ms per step, the D step / G step split, peak GiB,
     audio seconds trained per second and one traced step's device idle
     share, f32 and bf16; the log-mel on the card with TF32 allowed globally
     against the CPU's (MEL_TF32_TOL); one tiny f32 step (initial channel
     16, segment 1600, B=2) card vs CPU (GAN_SMALL_LOSS_RTOL); then the
     exported g_ through `hifigan_inference --fuse_tail --device cuda` on
     two wavs: exactly one f32 fused stage and one tail launch per file,
     each held to its plain version on the last file's inputs;
 17. data-parallel training at full width (parallel/, one process per
     device), phases 17-20's recipe cells at PAR_DEPTH's cut depth (VoMix 2
     layers, CoMix T2S 2 + 2; every width the recipes': their gates hold a
     rank against one process on the same model, and the launch counts
     below scale with the depth: "8 / 8 / 8" reads 2 / 2 / 2 there, "4
     causal" 2): (a) the VoMix recipe (bf16, B=8, T=832) through the train CLI
     for 4 steps in a process group of one over NCCL
     (`--coordinator_address 127.0.0.1:<free port> --num_processes 1
     --process_id 0`) and again without a group: losses, grad norms and the
     final state bit for bit equal, one gradient all-reduce a step, phase
     8's launches; (b) two ranks on the one card over gloo (NCCL refuses two
     ranks on one device; gloo's all_reduce and broadcast on device tensors
     are checked first): the VoMix recipe (global B 8, 4 rows a rank) and
     the CoMix T2S recipe (global B 6, 3 a rank, the causal kernels), each
     in bf16 and f32, for 2 steps, against one process on the same global
     batches and draws (DP_RTOL, the parameter bounds, the two ranks' bit
     for bit, 8 / 8 / 8 launches a VoMix step and 4 causal of each a T2S
     step on every rank); (c) the GAN step at the covomix config (batch 80,
     40 a rank, f32) for 2 steps the same way; ms per step at world 1 and
     dp=2, the all-reduce's ms and bytes per step, each rank's peak GiB;
 18. tensor-parallel and FSDP training at full width (parallel/mesh.py,
     tensor.py, train_step.py), on phase 17's items and one-process
     references, ranks sharing the one card over gloo (the collectives of
     this slice checked first on device tensors): (a) tp=2, the VoMix and
     CoMix T2S recipes in bf16 and f32; (b) dp=2 with --fsdp, the VoMix
     bf16 cell; (c) dp=2 x tp=2 with --fsdp (four ranks), the VoMix bf16
     cell; 2 steps each: every rank's losses and grad norms within DP_RTOL
     of one process, the gathered parameters within phase 17's bounds, the
     parts two ranks both hold bit for bit, each rank step's flash launches
     at its H / tp heads (8 / 8 / 8 and 8 pre-passes a bf16 VoMix step, 4
     causal of each a T2S step), its tp collectives, gradient collectives
     and parameter gathers as counted; ms a step, the tp collectives' count,
     bytes and host ms, the resident bytes of parameters, Adam moments and
     EMA and the peak GiB of each rank;
 19. pipeline- and sequence-parallel training at full width
     (parallel/pipeline.py, ring.py, collectives.py), on phase 17's VoMix
     items and one-process references, ranks sharing the one card over gloo
     (the ppermute and the axis sum checked first on device tensors): (a)
     pp=2 with 4 microbatches and (b) sp=2, each in bf16 and f32; (c) dp=2 x
     pp=2 and dp=2 x sp=2 in bf16 (four ranks); 2 steps each: every rank's
     losses and grad norms within DP_RTOL of one process, the gathered and
     unstacked parameters within phase 17's bounds, the parts two ranks both
     hold bit for bit, the first-half skip placeholders (value, gradient,
     EMA) exactly 0, each rank step's flash launches ((M + pp - 1) x depth
     / pp = 20 lse forwards, dQ and dK/dV, and 20 pre-passes in bf16, under
     pp; none under sp), its ppermutes (8 under pp, 20 under sp) and
     gradient collectives as counted; ms a step, the ppermutes' count,
     bytes and host ms, the resident bytes and peak GiB of each rank; (d)
     `ring.sample_sp` at sp=2 on a full-width acoustic model (2 rows x 912
     frames, cond_scale 0.7, f32) against `acoustic.sample` on the card with
     the same noise (SAMPLE_SP_RTOL), no flash launch, and the same call
     with TF32 allowed, a control whose error must exceed the bound;
 20. BMUF training and dialogue serving over dp at full width
     (parallel/bmuf.py, serving.py, serve_batch.py), ranks sharing the one
     card over gloo in phase 18-19's two-rank spawn: (a) the VoMix recipe
     at dp=2 (global B 8) in bf16 and f32 and the CoMix T2S recipe at dp=2
     (global B 6) in bf16, `--bmuf_sync 2 --bmuf_warmup 1` and the default
     block momentum 0.5 for 4 steps (step 1 the warmup sync, 2 and 4 block
     syncs, 3 local), each against one process that runs the two workers'
     local steps one after the other and the BMUF update on the stack: the
     ranks' parameters equal (by bit checksum) after steps 1, 2 and 4 and
     apart after step 3, Adam's count and moments reset at step 1, every
     rank's losses and grad norms within DP_RTOL and its parameters within
     phase 17's bounds of the reference, no gradient all-reduce, one sync
     collective of the parameters' bytes on a sync step and none on the
     local one, 8 / 8 / 8 flash launches (and 8 pre-passes in bf16) a VoMix
     rank step and 4 / 4 / 4 causal a T2S one; ms a step per rank (local
     and sync apart), the sync collectives' bytes and host ms, resident
     bytes (parameters, Adam, EMA, BMUF global and smoothed) and peak GiB;
     (b) `BatchedPipeline(mesh=)` at dp=2 on phase 4's serving models
     (global B 8, decode 512) in f32 (TF32 off) and bf16 against the
     one-process pipeline with the same inputs and generator seed: tokens,
     lengths, num_steps and the generator's next draw equal (bf16: tokens
     by hold_tokens' near-tie rule), the wav within SERVE_DP_WAV_TOL of
     max |wav|, both ranks' gathered wavs bit for bit, 256 flash forwards
     (and 256 pre-passes in bf16) per rank call; ms a call per rank
     against one process; (c) after phase 10's `serve_batch`, the same
     command with `--multihost` in a torchrun-style environment of one
     process over NCCL: every wav bit for bit;
 21. data preparation and the file-level evals at full width (run after
     phase 14, on phase 4's VoMix and CoMix T2S): seeded 8 kHz wavs of
     EVAL_SECONDS (VoSingle utterances; VoMix -A / -B streams and their sum),
     `prepare_mels --device cuda` held against `--device cpu`
     (MEL_CARD_TOL), seeded code siblings and `.txt` files;
     `evaluate_metrics --device cuda` on 4 pairs (finite, the trailer, the
     CPU run within METRICS_CARD_TOL); stft_complex / istft and light /
     dynamic convolution card vs CPU; then, in f32, evaluate_acoustic_files
     (a seeded VoSingle model), evaluate_acoustic_two_one_files (phase 4's
     VoMix), evaluate_acoustic_two_two_files (a seeded two_two model) on
     EVAL_FILES files each (exactly 16 x 2 x 8 = 256 f32 forwards per file,
     no pre-pass) and evaluate_t2s_files (phase 4's T2S, max_length cut to
     EVAL_T2S_MAX_LENGTH, no flash launch), every 'l2' finite and > 0;
     sample_adaptive in bf16 at ADAPTIVE_SHAPE, cond_scale 0.7 (56 forwards
     and 56 pre-passes per attempt), sample_regression in f32 with CFG (16
     forwards: two separate forwards), and a small f32 sample_adaptive card
     vs CPU (equal attempts, ADAPTIVE_CPU_TOL);
 22. K optimizer steps per dispatch (`train.loop.make_multi_step`, the
     train CLI's --steps_per_dispatch; run after phase 9), K = MULTI_K = 4:
     for each MULTI_CELLS cell at full width (VoMix bf16 B=8 T=832, CoMix
     T2S bf16 B=6 decoder T 1026, VoMix f32), from one state and generator
     4 eager steps against one captured dispatch, parameters, EMA, Adam's
     moments and counts, the 4 losses and grad norms and the generator's
     next draw bit for bit; the launches one replay runs, recorded at the
     capture, exactly 4 steps' flash kernels (8 lse forwards, dQ, dK/dV and
     pre-passes a VoMix bf16 step, 4 causal of each a T2S step, 8 f32 tiled
     of each a VoMix f32 step), and one traced replay showing them; the
     bf16 cells' ms a step eager against captured over MULTI_DISPATCHES
     dispatches, capture seconds, each window's idle share, the graph's
     pool and peak GiB; then `train.cli.main` on the VoMix recipe (depth
     cut to MULTI_CLI_DEPTH) with --steps_per_dispatch 4 to 8 and --resume
     to 12 (saves at 4, 8, 12), against an eager resume from the
     dispatched step 8, the saved states at 12 bit for bit;
 23. the CoVoSingle family at full width (run after phase 14, on phase 6's
     checkpoints and prompts): seeded CoSingle T2S (one output stream,
     target dim 512) and VoSingle (80-d, one phoneme stream) checkpoints;
     the monologue CLI in covosingle (--fuse_tail), covosinx (exact) and
     covomix (--fuse_tail) on one script, the dialogue CLI in covosingle
     (--fuse_tail) and covosinx (exact) on DIALOGUE_SCRIPT's three turns,
     each with phase 6's gates per flow sample and vocode (256 flash forwards
     and pre-passes, one stage and tail launch with --fuse_tail, none
     without), one decode a turn in the per-turn modes' dialogues, one flow
     a turn in covosingle's, int16 wavs of 160 samples per frame; each
     captured decode's text bucket, capture s and pool GiB, the graphs kept
     (phase 14's dropped first, this phase's after); the one-stream captured
     decode against the direct step on its first SINGLE_HELD steps (tokens
     up to hold_tokens' near-tie, steps, the generator's next draw), then
     timed over the whole decode; the flash forward held and timed at the
     covosinx dialogue's flow shape, the fused stage / tail at a covosingle
     turn's vocode inputs; small f32 covosingle (fused, SMALL_SYNTH_WAV_TOL)
     and covosinx (exact, SMALL_WAV_TOL) dialogues card vs CPU; then the
     VoSingle (B=6, T=832) and CoSingle (B=10, decoder T 578-1026) recipes
     through the train CLI: bf16 SINGLE_TRAIN_STEPS steps with an eval and
     its top-k save, --resume for one more; f32 SINGLE_F32_STEPS steps;
     every step exactly its flash launches (VoSingle 8 lse forwards, dQ,
     dK/dV and, in bf16, 8 pre-passes; CoSingle 4 causal of each), the
     VoSingle eval 256 forwards and pre-passes per eval batch, the CoSingle
     eval none; the bf16 step's split and a traced step's idle share; the
     three kernels held at each recipe's shape (bf16, f32); two tiny f32
     steps of each recipe card vs CPU;
 24. print a `kernels` JSON line (phase 13's launches as
     `speculative_launches` and the draft fit's replays of its captured
     dispatch apart as `speculative_fit_replays`, phase 15's as
     `bench_launches` and its B=64 fused check as `bench_check`, phase 16's as
     `gan_export_launches`, phase 17's as `dp_world1_launches` and
     `dp2_launches_per_rank_step`, phase 18's as
     `tp_launches_per_rank_step`, phase 19's as `pp_launches_per_rank_step`
     and `sp_launches_per_rank_step`, phase 20's as
     `bmuf_launches_per_rank_step` and `serve_dp_launches_per_rank_call`,
     phase 21's as `eval_files_launches` and `adaptive_launches`, phase
     22's as `multi_step_launches_per_dispatch`, phase 23's as
     `single_launches` per CLI run, `single_eval_launches`,
     `single_launches_per_train_step` and its holds as `single_check` and
     `single_shapes`, phases 17-20's depth as `parallel_depth`,
     the fused kernels' and the forward's
     phase-15 times as `bench_shapes`) and, last, {"ok": true, "device":
     {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak (H100 SXM data sheet)
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores (the f32 kernels' scalar FMAs; same sheet)
H100_BYTES_PER_S = 3.35e12    # HBM3 bandwidth (H100 SXM data sheet)
BF16_TOL = 1e-2               # |out| <~ 1: a few bf16 ulps (2^-8 at 1) of p and out rounding
F32_TOL = 1e-4                # f32: summation order and __expf vs expf only
LSE_TOL = 1e-4                # lse = m + log(l): |lse| ~ 10, l a sum of __expf terms (~2 ulps each)
# backward kernels against their plain versions in bf16: both round p and ds
# to bf16 at the same points and the outputs once, so an f32 sum taken in
# another order can only flip a rounding to the neighbouring value: a few
# ulps (2^-8 relative) of the output's scale at worst
BWD_BF16_TOL = 4 * 2 ** -8
# bf16 gradients through the autograd Function (kernels) against torch
# autograd through the plain forward: autograd rounds other intermediates
# (the gradient of p, of the rotated q and k) to bf16, so the two differ by
# several bf16 roundings; a wrong rotation or lse shows as errors of order 1
AUTOGRAD_BF16_TOL = 2 ** -4
AUTOGRAD_F32_TOL = 1e-5       # f32 both sides: summation order only
# card vs CPU wav of the small f32 serving run: both sides f32, so only
# summation order differs; an H100 80GB HBM3 read 2.98e-8, this is ~30x that
SMALL_WAV_TOL = 1e-6
SERVING_DH = 64
EDGE_DH = (16, 32, 48, 128, 256)   # 32: the small f32 model's head dim
# fused vocoder stage / tail against their plain versions. f32: both sides
# true f32 (TF32 off), only the summation order differs. bf16: both round at
# the same points, so an f32 sum taken in another order can only flip a
# rounding to the neighbouring bf16 value (2^-8 relative), which the later
# convs carry: a few ulps of the output's scale at worst, far less on average.
VOC_F32_TOL = 1e-5
VOC_BF16_TOL = 4 * 2 ** -8   # four ulps at 1, x max(1, max |plain|)
VOC_BF16_MEAN_TOL = 1e-4     # mean |err|, x max(1, max |plain|): flips are rare
# card vs CPU wav of the small f32 Synthesizer run: f32 both sides, the
# full-width vocoder's fused kernels on the card against the unfused
# generator (conv by conv) on the CPU
SMALL_SYNTH_WAV_TOL = 1e-5
# card vs CPU, two f32 training steps of a tiny model (flash kernels on the
# card, einsum attention on the CPU): the losses differ by summation order
# only; Adam divides each gradient element by its own size, so an element
# whose gradient is small next to its leaf's rounding noise moves by up to a
# few thousandths of the learning rate (1e-3): parameters to 1e-2 of it
SMALL_TRAIN_LOSS_TOL = 1e-5
SMALL_TRAIN_PARAM_TOL = 1e-5
# The CoVoSingle family's small steps (phase 23) hold the parameters to Adam's own bound instead
# (param_agreement, as phase 17 holds a rank against one process): every element within DP_BOUND lr
# a step, all but DP_TIGHT_SHARE of them within DP_TIGHT lr (= SMALL_TRAIN_PARAM_TOL here). An H100
# read 1.324e-5 on the CoSingle check, in one GEGLU w1 element: the CPU alone, the flash route's plain
# version against the einsum route, moves the same leaf by 5.9e-6 (CoMix: 4.4e-6), so the few
# thousandths of the lr assumed above are exceeded by rounding-level gradients, not by a kernel
# a Lightning / HiFi-GAN file converted back to .npz against its source
# tree: weight-norm folding g * v / |v| with g = |v| computed in another
# order gives w back within a few f32 roundings (3e-7 measured on the CPU)
CKPT_WN_RTOL = 1e-6
# hifigan_inference, --fuse_tail against the exact (valid_len) path, f32
# with TF32 off: the fused kernels against cuDNN's convs differ by summation
# order only (the small Synthesizer run read 3e-8 end to end)
HIFI_FUSED_TOL = 1e-5
# HuBERT features (full width, 2 encoder layers, post-LN so |x| ~ 1) card vs
# CPU in f32 with TF32 off: sums of up to 3072 terms in another order through
# 7 convs, 2 layers and 4 layernorms; a wrong mask or route shows as O(1)
HUBERT_FEAT_TOL = 1e-3
DIALOGUE_SCRIPT = ("hello there, how are you doing today? [spkchange] i am fine, thank you. "
                   "[spkchange] good to hear [laughter] see you soon")


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3, behind_sleep: bool = False) -> float:
    """ms per call of fn, by CUDA events around `iters` calls issued back to
    back, as a path issues them: where a call's host side (Python, checks,
    allocation, launch) outlasts its kernels, the card waits and the host's
    time is what shows. With `behind_sleep`, the calls are first queued
    behind a ~50 ms sleep kernel, so that the events time the card's work
    alone (the device time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if behind_sleep:
        torch.cuda._sleep(100_000_000)   # SM cycles: ~50 ms at 1.98 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def both_times(results, key, fn, iters: int = 20) -> float:
    """results[f"{key}_ms"] (back to back) and results[f"{key}_device_ms"]
    (behind a sleep) of fn; returns the first."""
    results[f"{key}_device_ms"] = cuda_time_ms(fn, iters, behind_sleep=True)
    results[f"{key}_ms"] = cuda_time_ms(fn, iters)
    return results[f"{key}_ms"]


# ---------------------------------------------------------------------------
# phase 3: the flash kernel against its plain version


def flash_inputs(b, h, t, dh, dtype, seed, valid, rotary):
    import torch
    from covomix_tpu_torch.models import layers as L
    from covomix_tpu_torch.ops import flash_attention as FA

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, h, t, dh), generator=g, device="cuda").to(dtype) for _ in range(3))
    valid_arr = FA._valid_array(valid, b, t, "cuda")
    tables = None
    if rotary:
        tables = FA.rotary_tables_halfsplit(torch.arange(t, device="cuda"),
                                            L.rotary_freqs(dh, device="cuda"), dtype)
    return q, k, v, valid_arr, tables


def quick_case(f32_dh64: bool, dh, dtype) -> bool:
    """Whether a flash check case runs: every case, or with `f32_dh64` (the
    `--flash-f32` loop) only the f32 cases at head dim 64."""
    import torch

    return not f32_dh64 or (dh == 64 and dtype == torch.float32)


def check_flash(results, f32_dh64=False):
    import torch
    from covomix_tpu_torch.ops import flash_attention as FA

    cases = []
    for t in (512, 600, 912, 1024, 2048):
        cases += [(2, 4, t, 64, torch.bfloat16, t, False),
                  (2, 4, t, 64, torch.bfloat16, [1, t - 37], True)]
    cases += [(8, 16, 912, 64, torch.bfloat16, [912, 700, 1, 912, 912, 700, 1, 912], True),  # serving
              (2, 4, 600, 64, torch.float32, [600, 1], True),
              (4, 2, 512, 32, torch.float32, [512, 362, 512, 362], True),   # the small f32 run's shape
              (1, 2, 512, 16, torch.bfloat16, 300, True),
              (1, 2, 512, 32, torch.bfloat16, 300, False),
              (2, 2, 600, 48, torch.bfloat16, [555, 1], True),
              (1, 2, 600, 48, torch.float32, 600, True),
              (1, 2, 640, 128, torch.bfloat16, [500], True),
              (1, 2, 513, 128, torch.float32, 513, False),
              (2, 2, 700, 256, torch.bfloat16, [650, 700], True),
              (1, 2, 520, 256, torch.float32, 400, True)]
    worst = 0.0
    for i, (b, h, t, dh, dtype, valid, rotary) in enumerate(cases):
        if not quick_case(f32_dh64, dh, dtype):
            continue
        q, k, v, valid_arr, tables = flash_inputs(b, h, t, dh, dtype, i, valid, rotary)
        out = FA.KERNEL(q, k, v, valid_arr, tables)
        ref = FA.flash_attention_plain(q, k, v, valid_arr, tables)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        ok = bool(torch.isfinite(out).all()) and err <= tol
        log(f"flash check [{b},{h},{t},{dh}] {str(dtype)[6:]} valid={valid} rotary={rotary}: "
            f"max_abs_err {err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain version at case {i}")
        if dtype == torch.bfloat16:
            worst = max(worst, err)
    results["flash_check_max_abs_err"] = worst


def flash_agreement(what, out, ref, tol):
    """Max |out - ref| of a flash kernel's output (out, lse, dq, dk, dv)
    against its plain version, held to tol x max(1, max |plain|) (both round
    at the same points, so only the order of f32 sums differs); logged,
    raises on disagreement."""
    import torch

    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    scale = max(1.0, ref.float().abs().max().item())
    ok = (out.shape == ref.shape and out.dtype == ref.dtype and bool(torch.isfinite(out).all())
          and err.max().item() <= tol * scale)
    log(f"  {what}: max_abs_err {err.max().item():.3e}, mean {err.mean().item():.3e}, |plain| max {scale:.3g} "
        f"(tol {tol:g} x max(1, |plain|)) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the kernel disagrees with its plain version")
    return err.max().item()


def check_flash_training_case(b, h, t, dh, dtype, seed, valid, rotary, causal=False):
    """The forward with lse, dQ and dK/dV against their plain versions on the
    same inputs (causal: also the causal forward without lse); returns
    {kernel: max_abs_err}."""
    import torch
    from covomix_tpu_torch.ops import flash_attention as FA

    q, k, v, valid_arr, tables = flash_inputs(b, h, t, dh, dtype, seed, valid, rotary)
    dout = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(seed + 1000),
                       device="cuda").to(dtype)
    bf16 = dtype == torch.bfloat16
    log(f"flash training check [{b},{h},{t},{dh}] {str(dtype)[6:]} valid={valid} rotary={rotary} "
        f"causal={causal}:")
    out, lse = FA.KERNEL(q, k, v, valid_arr, tables, return_lse=True, causal=causal)
    ref, ref_lse = FA.flash_attention_plain(q, k, v, valid_arr, tables, return_lse=True, causal=causal)
    out_tol = BF16_TOL if bf16 else F32_TOL
    errs = {"fwd_lse": max(flash_agreement("out", out, ref, out_tol),
                           flash_agreement("lse", lse, ref_lse, LSE_TOL))}
    if causal:
        errs["fwd"] = flash_agreement("out without lse", FA.KERNEL(q, k, v, valid_arr, tables, causal=True), ref,
                                      out_tol)
    if tables is not None:
        # _FlashCoreRot rotates with the pre-pass (bf16) or _rotary_plain
        # (f32) and the backward reads what it saved: the kernel's own rotary
        # (bf16: the pre-pass; f32: in shared memory) must give the very
        # operands _rotary_plain gives, bit for bit
        q, k = FA._rotary_plain(q, *tables), FA._rotary_plain(k, *tables)
        out2, lse2 = FA.KERNEL(q, k, v, valid_arr, None, return_lse=True, causal=causal)
        same = torch.equal(out2, out) and torch.equal(lse2, lse)
        log(f"  kernel's rotary == _rotary_plain then the kernel, bit for bit: {same}")
        if not same:
            raise AssertionError("the kernel's rotary differs from _rotary_plain")
    delta = FA.flash_delta(dout, ref)
    tol = BWD_BF16_TOL if bf16 else F32_TOL
    bwd = (q, k, v, dout, ref_lse, delta, valid_arr, causal)
    errs["bwd_dq"] = flash_agreement("dq", FA.KERNEL.bwd_dq(*bwd), FA.flash_bwd_dq_plain(*bwd), tol)
    (dk, dv), (dk_p, dv_p) = FA.KERNEL.bwd_dkv(*bwd), FA.flash_bwd_dkv_plain(*bwd)
    errs["bwd_dkv"] = max(flash_agreement("dk", dk, dk_p, tol), flash_agreement("dv", dv, dv_p, tol))
    for bi in range(b):
        vl = int(valid_arr[bi if valid_arr.numel() > 1 else 0])
        if not (bool((dk[bi, :, vl:] == 0).all()) and bool((dv[bi, :, vl:] == 0).all())):
            raise AssertionError(f"key rows past valid_len {vl} did not get exact zeros")
    if tables is not None and FA.backward_takes_tables(q):
        # with the tables (bf16, and f32 at head dim 64), dq and dk leave
        # through the rotary's transpose (in the epilogue, or a pass after the
        # kernels that have none): bit-equal to _rotary_transpose of the
        # untabled outputs, and held to the plain versions with the tables
        dq_t = FA.KERNEL.bwd_dq(*bwd, rotary=tables)
        dk_t, dv_t = FA.KERNEL.bwd_dkv(*bwd, rotary=tables)
        dq = FA.KERNEL.bwd_dq(*bwd)
        same = (torch.equal(dq_t, FA._rotary_transpose(dq, *tables))
                and torch.equal(dk_t, FA._rotary_transpose(dk, *tables)) and torch.equal(dv_t, dv))
        log(f"  with tables: dq, dk == _rotary_transpose of the untabled kernels', dv unchanged, bit for bit: {same}")
        if not same:
            raise AssertionError("the backward's rotary transpose differs from _rotary_transpose")
        errs["bwd_dq"] = max(errs["bwd_dq"], flash_agreement("dq with tables", dq_t,
                                                             FA.flash_bwd_dq_plain(*bwd, rotary=tables), tol))
        errs["bwd_dkv"] = max(errs["bwd_dkv"], flash_agreement("dk with tables", dk_t,
                                                               FA.flash_bwd_dkv_plain(*bwd, rotary=tables)[0], tol))
    return errs


def check_flash_training(results, f32_dh64=False):
    """The training form of the flash kernels against their plain versions,
    in bf16 and f32: the training shape [8, 16, 832, 64], a ragged T, T above
    2048, valid_len [1] < T and [B], rotary on and off, the edge head dims;
    then the gradients of the autograd Function on the card against torch
    autograd through flash_attention_plain."""
    import torch
    from covomix_tpu_torch.ops import flash_attention as FA

    bf, f32 = torch.bfloat16, torch.float32
    cases = [(8, 16, 832, 64, bf, 832, True),                     # the training shape
             (2, 4, 832, 64, f32, 832, True),
             (2, 4, 300, 64, bf, [300, 1], True), (2, 4, 1026, 64, bf, [1026, 700], True),   # 2-row last tile
             (2, 4, 1000, 64, bf, [1000, 613], True), (2, 4, 1000, 64, f32, [1000, 613], False),
             (1, 2, 2100, 64, bf, 2100, False), (1, 2, 2100, 64, f32, 1500, True),
             (2, 2, 2304, 64, bf, 1999, True),
             (2, 2, 600, 16, bf, [600, 1], True), (1, 2, 520, 16, f32, 400, False),
             (2, 2, 700, 32, bf, [650, 700], True), (1, 2, 513, 32, f32, 513, True),
             (2, 2, 600, 48, bf, [555, 1], True), (1, 2, 600, 48, f32, 600, False),
             (1, 2, 640, 128, bf, [500], True), (2, 2, 513, 128, f32, [513, 200], True),
             (2, 2, 700, 256, bf, [650, 700], True), (1, 2, 520, 256, f32, 400, True)]
    worst = {}
    for i, (b, h, t, dh, dtype, valid, rotary) in enumerate(cases):
        if not quick_case(f32_dh64, dh, dtype):
            continue
        errs = check_flash_training_case(b, h, t, dh, dtype, 200 + i, valid, rotary)
        if dtype == bf:
            for key, e in errs.items():
                worst[key] = max(worst.get(key, 0.0), e)
    for key, e in worst.items():
        results[f"{key}_check_max_abs_err"] = e

    # gradients of _FlashCoreRot (rotary, kernel forward with lse, dQ and
    # dK/dV with the tables) against torch autograd through the plain version
    for b, h, t, dtype, valid, tol in ((2, 4, 1000, f32, [1000, 613], F32_TOL),
                                       (8, 16, 832, bf, 832, AUTOGRAD_BF16_TOL)):
        if not quick_case(f32_dh64, 64, dtype):
            continue
        q, k, v, valid_arr, tables = flash_inputs(b, h, t, 64, dtype, 300 + t, valid, True)
        w = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(7), device="cuda").to(dtype)
        grads = []
        for fn in (lambda q, k, v: FA.flash_attention(q, k, v, valid_len=valid_arr, rotary=tables),
                   lambda q, k, v: FA.flash_attention_plain(q, k, v, valid_arr, tables)):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            out = fn(*leaves)
            grads.append(torch.autograd.grad((out.float() * w.float()).sum(), leaves))
        log(f"autograd through the kernels vs through the plain version [{b},{h},{t},64] {str(dtype)[6:]} "
            f"valid={valid} rotary:")
        for name, a, r in zip(("dq", "dk", "dv"), *grads):
            flash_agreement(name, a, r, tol)


def check_flash_causal(results, f32_dh64=False):
    """The causal form of the three kernels (the T2S training decoder's) against
    their plain versions, in bf16 and f32: the T2S step's shape [6, 8, 1026,
    64], odd T 513 / 1025 / 2049 and even 2050 (one live row in the last
    tile, or two), T under 512, valid_len [1] < T and [B] with a row < T,
    rotary off (the T2S path) and on, the edge head dims; then the gradients
    of the autograd Function with causal=True against torch autograd through
    the plain forward. Every key row past valid_len must get exact zeros."""
    import torch
    from covomix_tpu_torch.ops import flash_attention as FA

    bf, f32 = torch.bfloat16, torch.float32
    cases = [(6, 8, 1026, 64, bf, 1026, False),                    # the T2S step's shape
             (2, 4, 1026, 64, f32, 1026, False),
             (2, 4, 513, 64, bf, [513, 300], False), (2, 4, 513, 64, f32, [513, 300], False),
             (2, 4, 1025, 64, bf, 700, False), (2, 4, 1025, 64, f32, [1025, 1], False),
             (1, 2, 2049, 64, bf, 2049, False), (1, 2, 2050, 64, f32, 1999, False),
             (2, 2, 2050, 64, bf, [2050, 1234], False),
             (2, 4, 300, 64, bf, [300, 1], False), (2, 4, 300, 64, f32, 300, False),
             (2, 4, 600, 64, bf, [600, 451], True), (1, 2, 600, 64, f32, 600, True),
             (2, 2, 513, 16, bf, [513, 200], False), (1, 2, 520, 16, f32, 400, True),
             (2, 2, 700, 32, bf, [650, 700], True), (1, 2, 600, 32, f32, 600, False),
             (2, 2, 520, 48, bf, [520, 1], True), (1, 2, 600, 48, f32, 555, False),
             (1, 2, 640, 128, bf, [500], False), (2, 2, 513, 128, f32, [513, 200], True),
             (2, 2, 700, 256, bf, [650, 700], False), (1, 2, 520, 256, f32, 400, True)]
    worst = {}
    for i, (b, h, t, dh, dtype, valid, rotary) in enumerate(cases):
        if not quick_case(f32_dh64, dh, dtype):
            continue
        errs = check_flash_training_case(b, h, t, dh, dtype, 500 + i, valid, rotary, causal=True)
        if dtype == bf:
            for key, e in errs.items():
                worst[key] = max(worst.get(key, 0.0), e)
    for key, e in worst.items():
        results[f"{key}_causal_check_max_abs_err"] = e

    for b, h, t, dtype, valid, tol in ((2, 4, 1025, f32, [1025, 613], AUTOGRAD_F32_TOL),
                                       (6, 8, 1026, bf, 1026, AUTOGRAD_BF16_TOL)):
        if not quick_case(f32_dh64, 64, dtype):
            continue
        q, k, v, valid_arr, _ = flash_inputs(b, h, t, 64, dtype, 600 + t, valid, False)
        w = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(8), device="cuda").to(dtype)
        grads = []
        for fn in (lambda q, k, v: FA.flash_attention(q, k, v, valid_len=valid_arr, causal=True),
                   lambda q, k, v: FA.flash_attention_plain(q, k, v, valid_arr, causal=True)):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            grads.append(torch.autograd.grad((fn(*leaves).float() * w.float()).sum(), leaves))
        log(f"causal autograd through the kernels vs through the plain version [{b},{h},{t},64] "
            f"{str(dtype)[6:]} valid={valid}:")
        for name, a, r in zip(("dq", "dk", "dv"), *grads):
            flash_agreement(name, a, r, tol)


def check_rotary_prepass(results):
    """The bf16 rotary pre-pass against `_rotary_plain`, bit for bit
    (torch.equal): at the serving shape [8, 16, 912, 64], at odd T, with
    tables longer than T, and at the edge head dims."""
    import torch
    from covomix_tpu_torch.models import layers as L
    from covomix_tpu_torch.ops import flash_attention as FA

    for b, h, t, dh in ((8, 16, 912, 64), (2, 3, 301, 64), (1, 2, 1027, 64), (2, 2, 77, 16), (1, 2, 99, 48),
                        (1, 2, 65, 128), (1, 1, 33, 256)):
        q, k, _, _, tables = flash_inputs(b, h, t, dh, torch.bfloat16, 40 + t, t, True)
        if t == 1027:   # tables of 1100 positions, the first T of them used
            tables = FA.rotary_tables_halfsplit(torch.arange(1100, device="cuda"),
                                                L.rotary_freqs(dh, device="cuda"), torch.bfloat16)
        before = FA.KERNEL.rotary_launches
        qr, kr = FA.KERNEL.rotary(q, k, *tables)
        torch.cuda.synchronize()
        cos, sin = tables[0][:t], tables[1][:t]
        same = torch.equal(qr, FA._rotary_plain(q, cos, sin)) and torch.equal(kr, FA._rotary_plain(k, cos, sin))
        log(f"rotary pre-pass [{b},{h},{t},{dh}] == _rotary_plain, bit for bit: {same}")
        if not same or FA.KERNEL.rotary_launches != before + 1:
            raise AssertionError(f"the rotary pre-pass differs from _rotary_plain at [{b},{h},{t},{dh}]")
    results["rotary_check_bit_equal"] = True


def time_flash(results, key, b, t, valid):
    """The forward at [b, 16, t, 64] bf16 with rotary and a run's own valid
    lengths (one per row, or one for all): the attention kernel alone on the
    pre-rotated inputs (results[f"{key}_ms"] etc., the kernel's own entry),
    the rotary pre-pass (f"{key}_rotary_*"), the two together as the path
    calls them (f"{key}_with_prepass_ms": the gated number), each back to
    back and behind a sleep (`both_times`), beside the plain version and the
    SDPA yardstick on the pre-rotated inputs. The forward's output on the
    timed inputs is held against the plain version's (BF16_TOL)."""
    import torch
    import torch.nn.functional as F
    from covomix_tpu_torch.ops import flash_attention as FA

    h, dh = 16, 64
    q, k, v, valid_arr, tables = flash_inputs(b, h, t, dh, torch.bfloat16, 99, valid, True)
    out = FA.KERNEL(q, k, v, valid_arr, tables)
    ref = FA.flash_attention_plain(q, k, v, valid_arr, tables)
    err = results[f"{key}_max_abs_err"] = (out.float() - ref.float()).abs().max().item()
    ok = bool(torch.isfinite(out).all()) and err <= BF16_TOL
    log(f"flash check at the timed inputs [{b},{h},{t},{dh}] bf16: max_abs_err {err:.3e} (tol {BF16_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash kernel disagrees with its plain version at [{b},{h},{t},{dh}]")
    del out, ref
    both = both_times(results, f"{key}_with_prepass", lambda: FA.KERNEL(q, k, v, valid_arr, tables))
    qr, kr = FA._rotary_plain(q, *tables), FA._rotary_plain(k, *tables)
    time_rotary_prepass(results, f"{key}_rotary", q, k, tables)
    ms = both_times(results, key, lambda: FA.KERNEL(qr, kr, v, valid_arr, None))
    results[f"{key}_plain_ms"] = cuda_time_ms(lambda: FA.flash_attention_plain(qr, kr, v, valid_arr, None),
                                              iters=5)
    mask = None
    if int(valid_arr.min()) < t:
        mask = (torch.arange(t, device="cuda")[None, :] < valid_arr[:, None])[:, None, None, :]
    both_times(results, f"{key}_library", lambda: F.scaled_dot_product_attention(qr, kr, v, attn_mask=mask))
    live = valid_arr.long().expand(b).sum().item()
    flops = 4.0 * h * dh * t * live
    nbytes = 4 * b * h * t * dh * 2 + valid_arr.numel() * 4   # q, k, v read, out written; valid
    bound_flops_ms, bound_bytes_ms = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    bound = results[f"{key}_bound_ms"] = max(bound_flops_ms, bound_bytes_ms)
    by = results[f"{key}_bound_by"] = "operations" if bound_flops_ms >= bound_bytes_ms else "bytes"
    r = {name: results[f"{key}{part}"] for name, part in (
        ("prepass", "_rotary_ms"), ("prepass_dev", "_rotary_device_ms"), ("dev", "_device_ms"),
        ("both_dev", "_with_prepass_device_ms"), ("sdpa", "_library_ms"), ("sdpa_dev", "_library_device_ms"))}
    log(f"flash timing [{b},{h},{t},{dh}] bf16 rotary, valid={valid_arr.tolist()} (ms back to back / behind a "
        f"sleep): pre-pass + attention {both:.4f} / {r['both_dev']:.4f}; pre-pass {r['prepass']:.4f} / "
        f"{r['prepass_dev']:.4f}; attention {ms:.4f} / {r['dev']:.4f}; SDPA {r['sdpa']:.4f} / {r['sdpa_dev']:.4f}; "
        f"plain {results[f'{key}_plain_ms']:.4f}; bound {bound:.4f} ({by}: {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB) -> attention {flops / r['dev'] / 1e9:.1f} TFLOP/s on the card")


def time_rotary_prepass(results, key, q, k, tables):
    """The rotary pre-pass on q, k (bf16 [B, H, T, dh]) beside `_rotary_plain`
    of both (its plain version, and the one PyTorch call per tensor that
    computes the same function, timed once for both fields) and its bound:
    bytes, each of q, k read and each of their rotated copies written once,
    the tables read once."""
    from covomix_tpu_torch.ops import flash_attention as FA

    t = q.shape[2]
    cos, sin = tables[0][:t], tables[1][:t]
    ms = both_times(results, key, lambda: FA.KERNEL.rotary(q, k, cos, sin), iters=50)
    plain = cuda_time_ms(lambda: (FA._rotary_plain(q, cos, sin), FA._rotary_plain(k, cos, sin)), iters=20)
    results[f"{key}_plain_ms"] = results[f"{key}_library_ms"] = plain
    nbytes = 4 * q.numel() * 2 + 2 * cos.numel() * 2
    results[f"{key}_bound_ms"] = nbytes / H100_BYTES_PER_S * 1e3
    results[f"{key}_bound_by"] = "bytes"
    qr, kr = FA.KERNEL.rotary(q, k, cos, sin)
    same = bool((qr == FA._rotary_plain(q, cos, sin)).all() and (kr == FA._rotary_plain(k, cos, sin)).all())
    results[f"{key}_max_abs_err"] = 0.0 if same else float("inf")
    log(f"rotary pre-pass timing {list(q.shape)} bf16: {ms:.4f} ms back to back, "
        f"{results[f'{key}_device_ms']:.4f} ms behind a sleep, _rotary_plain of q and k {plain:.4f} ms, bound "
        f"{results[f'{key}_bound_ms']:.4f} ms (bytes: {nbytes / 1e6:.1f} MB) -> "
        f"{nbytes / results[f'{key}_device_ms'] / 1e6:.1f} GB/s on the card; bit-equal on the timed inputs {same}")
    if not same:
        raise AssertionError("the rotary pre-pass differs from _rotary_plain on the timed inputs")


def flash_host_us(b=8, h=16, t=912, dh=64, iters=100) -> dict:
    """Host microseconds per call of the bf16 forward's wrapper
    (`flash_attention.KERNEL`: checks, allocations, ctypes launches) at
    [b, h, t, dh]: the host clock around `iters` calls while the card is kept
    busy behind a sleep kernel, so no call waits for the card. "forward with
    rotary" is the call the flow sampler makes (tables given); "attention
    alone" the same call on pre-rotated q and k, without tables."""
    import torch
    from covomix_tpu_torch.ops import flash_attention as FA

    q, k, v, valid_arr, tables = flash_inputs(b, h, t, dh, torch.bfloat16, 98, t, True)
    qr, kr = FA._rotary_plain(q, *tables), FA._rotary_plain(k, *tables)
    calls = {"forward with rotary": lambda: FA.KERNEL(q, k, v, valid_arr, tables),
             "attention alone": lambda: FA.KERNEL(qr, kr, v, valid_arr, None)}
    out = {}
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)   # ~100 ms: longer than the host takes to issue the calls
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        out[name] = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
    return out


def time_flash_host(results):
    us = results["flash_host_us"] = flash_host_us()
    log("flash forward wrapper, host us per call at [8,16,912,64] bf16: "
        + ", ".join(f"{name} {v:.1f}" for name, v in us.items()))


def bound_and_log(results, key, shape, flops, nbytes, f32=False):
    """results[f"{key}_bound_ms"] / f"{key}_bound_by" from the work's operations
    (over the bf16 tensor-core peak, or with `f32` the f32 FMA peak) and
    bytes, and one log line of the kernel's, plain version's and library
    call's times (back to back / behind a sleep)."""
    bf_ms, bb_ms = flops / (H100_F32_FLOPS if f32 else H100_BF16_FLOPS) * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    bound = results[f"{key}_bound_ms"] = max(bf_ms, bb_ms)
    by = results[f"{key}_bound_by"] = "operations" if bf_ms >= bb_ms else "bytes"
    dev = results[f"{key}_device_ms"]
    log(f"{key} timing {shape} {'f32' if f32 else 'bf16'} (ms back to back / behind a sleep): kernel "
        f"{results[f'{key}_ms']:.4f} / "
        f"{dev:.4f}, library {results[f'{key}_library_ms']:.4f} / {results[f'{key}_library_device_ms']:.4f}, "
        f"plain {results[f'{key}_plain_ms']:.4f}, bound {bound:.4f} ({by}: {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB) -> {flops / dev / 1e9:.1f} TFLOP/s on the card")


def time_flash_training(results, b=8, h=16, t=832, dh=64):
    """The forward with lse, dQ and dK/dV at the training shape (bf16, rotary,
    all keys live), each beside its plain version, its bound and one PyTorch
    call of the same function: SDPA on the pre-rotated inputs for the
    forward, the gradient of SDPA (one call computes dQ, dK and dV) for the
    pair. The outputs on the timed inputs are held against the plain
    versions'."""
    import torch
    import torch.nn.functional as F
    from covomix_tpu_torch.ops import flash_attention as FA

    bf = torch.bfloat16
    q, k, v, valid_arr, tables = flash_inputs(b, h, t, dh, bf, 401, t, True)
    dout = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(402), device="cuda").to(bf)
    log(f"flash training kernels at the timed inputs [{b},{h},{t},{dh}] bf16 rotary:")
    out, lse = FA.KERNEL(q, k, v, valid_arr, tables, return_lse=True)
    ref, ref_lse = FA.flash_attention_plain(q, k, v, valid_arr, tables, return_lse=True)
    results["fwd_lse_max_abs_err"] = max(flash_agreement("out", out, ref, BF16_TOL),
                                         flash_agreement("lse", lse, ref_lse, LSE_TOL))
    qr, kr = FA._rotary_plain(q, *tables), FA._rotary_plain(k, *tables)
    delta = FA.flash_delta(dout, ref)
    bwd = (qr, kr, v, dout, ref_lse, delta, valid_arr, False)
    # as the VoMix step calls them: rotated q and k, the tables (dq and dk
    # leave through the rotary's transpose)
    dq = FA.KERNEL.bwd_dq(*bwd, rotary=tables)
    results["bwd_dq_max_abs_err"] = flash_agreement("dq", dq, FA.flash_bwd_dq_plain(*bwd, rotary=tables),
                                                    BWD_BF16_TOL)
    (dk, dv), (dk_p, dv_p) = FA.KERNEL.bwd_dkv(*bwd, rotary=tables), FA.flash_bwd_dkv_plain(*bwd, rotary=tables)
    results["bwd_dkv_max_abs_err"] = max(flash_agreement("dk", dk, dk_p, BWD_BF16_TOL),
                                         flash_agreement("dv", dv, dv_p, BWD_BF16_TOL))
    del out, ref, dk, dv, dk_p, dv_p

    timed = {   # the forward's entry is the attention kernel alone, on the pre-rotated inputs
        "fwd_lse": (lambda: FA.KERNEL(qr, kr, v, valid_arr, None, return_lse=True),
                    lambda: FA.flash_attention_plain(qr, kr, v, valid_arr, None, return_lse=True)),
        "bwd_dq": (lambda: FA.KERNEL.bwd_dq(*bwd, rotary=tables),
                   lambda: FA.flash_bwd_dq_plain(*bwd, rotary=tables)),
        "bwd_dkv": (lambda: FA.KERNEL.bwd_dkv(*bwd, rotary=tables),
                    lambda: FA.flash_bwd_dkv_plain(*bwd, rotary=tables)),
    }
    for key, (kern, plain) in timed.items():
        both_times(results, key, kern)
        results[f"{key}_plain_ms"] = cuda_time_ms(plain, iters=5)
    untabled = {key: cuda_time_ms(fn, behind_sleep=True) for key, fn in (
        ("dq", lambda: FA.KERNEL.bwd_dq(*bwd)), ("dk/dv", lambda: FA.KERNEL.bwd_dkv(*bwd)))}
    # what a backward that saves the unrotated q and k runs in PyTorch
    # around the kernels, per layer: the re-rotation of q and k, then the
    # counter-rotation of dq and dk
    old_rot = both_times(results, "old_rotary_bwd", lambda: (
        FA._rotary_plain(q, *tables), FA._rotary_plain(k, *tables),
        FA._rotary_transpose(qr, *tables), FA._rotary_transpose(kr, *tables)))
    log(f"backward at [{b},{h},{t},{dh}] bf16, behind a sleep: with the tables (the VoMix step's form) dq "
        f"{results['bwd_dq_device_ms']:.4f} / dk-dv {results['bwd_dkv_device_ms']:.4f} ms, without "
        f"{untabled['dq']:.4f} / {untabled['dk/dv']:.4f} ms; the re-rotation and counter-rotation in PyTorch "
        f"that the tables replace: {old_rot:.4f} / {results['old_rotary_bwd_device_ms']:.4f} ms per layer "
        f"(back to back / behind a sleep)")
    # the call the path makes (pre-pass + attention: the gated number), and
    # what the lse output and the pre-pass cost, on these inputs
    both_times(results, "fwd_lse_with_prepass", lambda: FA.KERNEL(q, k, v, valid_arr, tables, return_lse=True))
    variants = {"no lse, with the pre-pass": cuda_time_ms(lambda: FA.KERNEL(q, k, v, valid_arr, tables)),
                "the rotary pre-pass alone": cuda_time_ms(lambda: FA.KERNEL.rotary(q, k, *tables))}
    log(f"forward with lse at [{b},{h},{t},{dh}] bf16 (ms back to back / behind a sleep): with the pre-pass "
        f"{results['fwd_lse_with_prepass_ms']:.4f} / {results['fwd_lse_with_prepass_device_ms']:.4f}, "
        f"attention alone {results['fwd_lse_ms']:.4f} / {results['fwd_lse_device_ms']:.4f}; "
        + ", ".join(f"{name} {ms:.4f}" for name, ms in variants.items()))
    both_times(results, "fwd_lse_library", lambda: F.scaled_dot_product_attention(qr, kr, v))
    leaves = [x.detach().clone().requires_grad_() for x in (qr, kr, v)]
    o = F.scaled_dot_product_attention(*leaves)
    both_times(results, "bwd_library", lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True))
    for key in ("bwd_dq", "bwd_dkv"):   # one call computes dQ, dK and dV
        results[f"{key}_library_ms"] = results["bwd_library_ms"]
        results[f"{key}_library_device_ms"] = results["bwd_library_device_ms"]
    del o, leaves

    n, rows = b * h * t * dh * 2, b * h * t * 4          # one [B,H,T,dh] bf16 tensor; one f32 [B,H,T] row array
    live = valid_arr.long().expand(b).sum().item()
    tab = 2 * t * dh * 2                                  # the two bf16 rotary tables the backward reads
    work = {"fwd_lse": (4.0 * h * dh * t * live, 4 * n + rows),                       # q,k,v,out; lse
            "bwd_dq": (6.0 * h * dh * t * live, 5 * n + 2 * rows + tab),              # q,k,v,dO,dq; lse,delta
            "bwd_dkv": (8.0 * h * dh * t * live, 6 * n + 2 * rows + tab)}             # q,k,v,dO,dk,dv; lse,delta
    for key, (flops, nbytes) in work.items():
        bound_and_log(results, key, [b, h, t, dh], flops, nbytes + valid_arr.numel() * 4)
    log_backward_pair(results, "", [b, h, t, dh])


def time_flash_f32(results, suffix, b, h, t, causal, rotary, dh=64):
    """The f32 training forms (the recipes' own precision) of the forward
    with lse, dQ and dK/dV at a training path's shape: VoMix [8, 16, 832, 64]
    with the rotary tables (suffix "_f32"), CoMix T2S [6, 8, 1026, 64] causal
    ("_causal_f32"), all keys live. The backward is called as the step calls
    it: rotated q and k (`_rotary_plain`, what `_FlashCoreRot` saves) and the
    tables, so dq and dk leave through the rotary's transpose in the kernels.
    Each output on the timed inputs is held against its plain version
    (F32_TOL), dq and dk with the tables also bit for bit against
    `_rotary_transpose` of the untabled kernels'; each kernel is timed back
    to back and behind a sleep beside its plain version, its bound at the f32
    peak and one PyTorch call of the same function on the pre-rotated inputs
    (f32 SDPA; the gradient of f32 SDPA, which computes dQ, dK and dV). Also
    logged: the untabled kernels and the `_unrotate` passes of dq and dk that
    a backward without the tables runs in PyTorch."""
    import torch
    import torch.nn.functional as F
    from covomix_tpu_torch.ops import flash_attention as FA

    f32 = torch.float32
    q, k, v, valid_arr, tables = flash_inputs(b, h, t, dh, f32, 411 + t, t, rotary)
    dout = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(412), device="cuda")
    if rotary:
        q, k = FA._rotary_plain(q, *tables), FA._rotary_plain(k, *tables)
    log(f"f32 flash training kernels at the timed inputs [{b},{h},{t},{dh}] rotary={rotary} causal={causal}:")
    out, lse = FA.KERNEL(q, k, v, valid_arr, None, return_lse=True, causal=causal)
    ref, ref_lse = FA.flash_attention_plain(q, k, v, valid_arr, None, causal, return_lse=True)
    results[f"fwd_lse{suffix}_max_abs_err"] = max(flash_agreement("out", out, ref, F32_TOL),
                                                 flash_agreement("lse", lse, ref_lse, LSE_TOL))
    bwd = (q, k, v, dout, ref_lse, FA.flash_delta(dout, ref), valid_arr, causal)
    dq, (dk, dv) = FA.KERNEL.bwd_dq(*bwd, rotary=tables), FA.KERNEL.bwd_dkv(*bwd, rotary=tables)
    results[f"bwd_dq{suffix}_max_abs_err"] = flash_agreement(
        "dq", dq, FA.flash_bwd_dq_plain(*bwd, rotary=tables), F32_TOL)
    dk_p, dv_p = FA.flash_bwd_dkv_plain(*bwd, rotary=tables)
    results[f"bwd_dkv{suffix}_max_abs_err"] = max(flash_agreement("dk", dk, dk_p, F32_TOL),
                                                  flash_agreement("dv", dv, dv_p, F32_TOL))
    if rotary:
        dq0, (dk0, _) = FA.KERNEL.bwd_dq(*bwd), FA.KERNEL.bwd_dkv(*bwd)
        same = torch.equal(dq, FA._rotary_transpose(dq0, *tables)) and torch.equal(dk, FA._rotary_transpose(dk0, *tables))
        log(f"  with tables: dq, dk == _rotary_transpose of the untabled kernels', bit for bit: {same}")
        if not same:
            raise AssertionError("the f32 backward's rotary transpose differs from _rotary_transpose")
        del dq0, dk0
    del out, ref, dq, dk, dv, dk_p, dv_p

    timed = {
        f"fwd_lse{suffix}": (lambda: FA.KERNEL(q, k, v, valid_arr, None, return_lse=True, causal=causal),
                             lambda: FA.flash_attention_plain(q, k, v, valid_arr, None, causal, return_lse=True)),
        f"bwd_dq{suffix}": (lambda: FA.KERNEL.bwd_dq(*bwd, rotary=tables),
                            lambda: FA.flash_bwd_dq_plain(*bwd, rotary=tables)),
        f"bwd_dkv{suffix}": (lambda: FA.KERNEL.bwd_dkv(*bwd, rotary=tables),
                             lambda: FA.flash_bwd_dkv_plain(*bwd, rotary=tables)),
    }
    for key, (kern, plain) in timed.items():
        both_times(results, key, kern, iters=10)
        results[f"{key}_plain_ms"] = cuda_time_ms(plain, iters=3, warmup=1)
    if rotary:
        untabled = {name: cuda_time_ms(fn, 10, behind_sleep=True) for name, fn in (
            ("dq", lambda: FA.KERNEL.bwd_dq(*bwd)), ("dk/dv", lambda: FA.KERNEL.bwd_dkv(*bwd)))}
        dq0, (dk0, _) = FA.KERNEL.bwd_dq(*bwd), FA.KERNEL.bwd_dkv(*bwd)
        unrot = both_times(results, f"unrotate{suffix}",
                           lambda: (FA._unrotate(dq0, tables), FA._unrotate(dk0, tables)))
        log(f"f32 backward at [{b},{h},{t},{dh}] behind a sleep: with the tables (the step's form) dq "
            f"{results[f'bwd_dq{suffix}_device_ms']:.4f} / dk-dv {results[f'bwd_dkv{suffix}_device_ms']:.4f} ms, "
            f"without {untabled['dq']:.4f} / {untabled['dk/dv']:.4f} ms; the _unrotate of dq and dk in PyTorch that "
            f"the tables replace: {unrot:.4f} / {results[f'unrotate{suffix}_device_ms']:.4f} ms per layer "
            f"(back to back / behind a sleep)")
        del dq0, dk0
    both_times(results, f"fwd_lse{suffix}_library",
               lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), iters=10)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    both_times(results, f"bwd{suffix}_library", lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True),
               iters=10)
    for key in (f"bwd_dq{suffix}", f"bwd_dkv{suffix}"):   # one call computes dQ, dK and dV
        results[f"{key}_library_ms"] = results[f"bwd{suffix}_library_ms"]
        results[f"{key}_library_device_ms"] = results[f"bwd{suffix}_library_device_ms"]
    del o, leaves

    n, rows = b * h * t * dh * 4, b * h * t * 4           # one [B,H,T,dh] f32 tensor; one f32 [B,H,T] row array
    pairs = b * h * t * (t + 1) / 2 if causal else b * h * t * t   # live (query, key) pairs, all keys valid
    tab = 2 * t * dh * 4 if rotary else 0                 # the two f32 rotary tables the backward reads
    work = {f"fwd_lse{suffix}": (4.0 * dh * pairs, 4 * n + rows),                  # q,k,v,out; lse
            f"bwd_dq{suffix}": (6.0 * dh * pairs, 5 * n + 2 * rows + tab),         # q,k,v,dO,dq; lse,delta
            f"bwd_dkv{suffix}": (8.0 * dh * pairs, 6 * n + 2 * rows + tab)}        # q,k,v,dO,dk,dv; lse,delta
    for key, (flops, nbytes) in work.items():
        bound_and_log(results, key, [b, h, t, dh], flops, nbytes + valid_arr.numel() * 4, f32=True)
    log_backward_pair(results, suffix, [b, h, t, dh])
    pair_bound = results[f"bwd_dq{suffix}_bound_ms"] + results[f"bwd_dkv{suffix}_bound_ms"]
    log(f"f32 backward pair{suffix.replace('_', ' ')}: {results[f'bwd_pair{suffix}_device_ms']:.4f} ms on the card, "
        f"{pair_bound / results[f'bwd_pair{suffix}_device_ms'] * 100:.1f} % of its {pair_bound:.4f} ms bound")


def f32_backward_times(results, iters=10):
    """Device ms of the f32 backward at the two training shapes, with the
    calls every tree since the causal form has (for --ab-training): the
    untabled dQ and dK/dV kernels, and `_backward` as the step calls it
    (delta, both kernels and, where the kernels take no tables, the
    `_unrotate` of dq and dk)."""
    import torch
    from covomix_tpu_torch.ops import flash_attention as FA

    for suffix, (b, h, t, causal, rotary) in F32_SHAPES.items():
        q, k, v, valid_arr, tables = flash_inputs(b, h, t, 64, torch.float32, 421 + t, t, rotary)
        g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(422), device="cuda")
        if rotary:
            q, k = FA._rotary_plain(q, *tables), FA._rotary_plain(k, *tables)
        out, lse = FA.KERNEL(q, k, v, valid_arr, None, return_lse=True, causal=causal)
        bwd = (q, k, v, g, lse, FA.flash_delta(g, out), valid_arr, causal)
        results[f"bwd_dq{suffix}_untabled_device_ms"] = cuda_time_ms(lambda: FA.KERNEL.bwd_dq(*bwd), iters,
                                                                     behind_sleep=True)
        results[f"bwd_dkv{suffix}_untabled_device_ms"] = cuda_time_ms(lambda: FA.KERNEL.bwd_dkv(*bwd), iters,
                                                                      behind_sleep=True)
        results[f"backward{suffix}_device_ms"] = cuda_time_ms(
            lambda: FA._backward(q, k, v, out, lse, g, valid_arr, causal, tables), iters, behind_sleep=True)


# the f32 training shapes: suffix -> (B, H, T, causal, rotary)
F32_SHAPES = {"_f32": (8, 16, 832, False, True), "_causal_f32": (6, 8, 1026, True, False)}


def log_backward_pair(results, suffix, shape):
    """The dQ + dK/dV pair's time beside one SDPA gradient call (dQ, dK and
    dV), both ways."""
    pair = {way: results[f"bwd_dq{suffix}{way}"] + results[f"bwd_dkv{suffix}{way}"] for way in ("_ms", "_device_ms")}
    lib = {way: results[f"bwd{suffix}_library{way}"] for way in ("_ms", "_device_ms")}
    results[f"bwd_pair{suffix}_device_ms"] = pair["_device_ms"]
    log(f"backward pair{suffix.replace('_', ' ')} at {shape}: dQ + dK/dV {pair['_ms']:.4f} / {pair['_device_ms']:.4f} "
        f"ms, SDPA gradient {lib['_ms']:.4f} / {lib['_device_ms']:.4f} ms (back to back / behind a sleep): "
        f"{pair['_device_ms'] / lib['_device_ms']:.2f}x by device time")


# ---------------------------------------------------------------------------
# phase 3b: the fused vocoder stage and tail against their plain versions


def vocoder_stage_params(channel, tail: bool, seed: int):
    """(up, blocks, post) of the rate-4 stage (tail=False) or the last stage
    of the generator with `channel` initial channels, random from a seed."""
    import torch
    from covomix_tpu_torch.models import vocoder as V

    cfg = V.VocoderConfig(upsample_initial_channel=channel)
    p = V.init_generator(torch.Generator(device="cuda").manual_seed(seed), cfg, device="cuda")
    i = len(cfg.upsample_rates) - (1 if tail else 2)
    n = len(cfg.resblock_kernel_sizes)
    return p["ups"][i], p["resblocks"][i * n:(i + 1) * n], p["conv_post"] if tail else None


def check_vocoder(results):
    """Both kernels in bf16 and f32 at the Synthesizer's shape (B=1, T=512
    mel frames), B=4 with a length that is not a multiple of the tile, inputs
    shorter than the halo, upsample_initial_channel 496, and the other
    channel padding of each kernel: a 32-channel and a 2-channel stage
    (initial channels 256, 16) and a 64-channel tail (1024) and 1-channel
    tail (16), one of odd length."""
    import torch
    from covomix_tpu_torch.ops import vocoder_tail as VT

    worst = {"stage": 0.0, "tail": 0.0}
    cases = [("stage", 500, 1, 20 * 512 + 4), ("tail", 500, 1, 80 * 512 + 16),
             ("stage", 500, 4, 1001), ("tail", 500, 4, 2002),
             ("stage", 500, 2, 1), ("tail", 500, 2, 2), ("stage", 500, 1, 3),
             ("stage", 496, 2, 700), ("tail", 496, 2, 1400),
             ("stage", 256, 2, 300), ("stage", 16, 1, 50), ("tail", 1024, 1, 601), ("tail", 16, 2, 100)]
    for ci, (kind, channel, b, t) in enumerate(cases):
        up, blocks, post = vocoder_stage_params(channel, kind == "tail", ci)
        g = torch.Generator(device="cuda").manual_seed(100 + ci)
        x = torch.randn((b, t, up["w"].shape[1]), generator=g, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype)
            packed = VT.pack_weights(up, blocks, post, (3, 7, 11), ((1, 3, 5),) * 3, dtype, xd.device)
            if kind == "tail":
                out = VT.TAIL(xd, packed)
                ref = VT.fused_tail_plain(xd, up, blocks, post)
            else:
                out = VT.STAGE(xd, packed)
                ref = VT.fused_stage_plain(xd, up, blocks)
            err = vocoder_agreement(f"fused {kind} check channel {channel}", xd, out, ref)
            if dtype == torch.bfloat16:
                worst[kind] = max(worst[kind], err)
    results["stage_check_max_abs_err"], results["tail_check_max_abs_err"] = worst["stage"], worst["tail"]


def vocoder_agreement(what, x, out, ref) -> float:
    """Max |out - ref| of a fused kernel on input `x` against its plain
    version, logged and held to the tolerances of x's dtype above; raises on
    disagreement."""
    import torch

    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    scale = max(1.0, ref.float().abs().max().item())
    if x.dtype == torch.bfloat16:
        ok = err.max().item() <= VOC_BF16_TOL * scale and err.mean().item() <= VOC_BF16_MEAN_TOL * scale
    else:
        ok = err.max().item() <= VOC_F32_TOL
    ok = ok and out.shape == ref.shape and out.dtype == ref.dtype and bool(torch.isfinite(out).all())
    log(f"{what} x{list(x.shape)} {str(x.dtype)[6:]}: max_abs_err {err.max().item():.3e}, "
        f"mean {err.mean().item():.3e}, |plain| max {scale:.3g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the kernel disagrees with its plain version")
    return err.max().item()


def unfused_stage(x, up, blocks, tail_post=None):
    """The port's unfused generator ops for the same stage (cuDNN convs)."""
    import torch
    from covomix_tpu_torch.models import layers as L
    from covomix_tpu_torch.models import vocoder as V

    u = 2 if tail_post is not None else 4
    h = L.conv_transpose1d(up, L.leaky_relu(x, V.LRELU_SLOPE), stride=u, padding=(4 - u) // 2, kernel=4)
    acc = None
    for j, kr in enumerate((3, 7, 11)):
        y = V._resblock1(blocks[j], h, kr, (1, 3, 5))
        acc = y if acc is None else acc + y
    h = acc / 3
    if tail_post is None:
        return h
    return torch.tanh(L.conv1d(tail_post, L.leaky_relu(h), padding=3))[..., 0].float()


def hold_vocoder(results, key, kind, x, up, blocks, post=None, what="the timed inputs"):
    """The stage's (kind "stage") or tail's ("tail") kernel on input x
    [B, T, Cin] with the default taps, its block plan logged, held against
    its plain version (vocoder_agreement) once, the error into
    results[f"{key}_max_abs_err"]; returns (kernel call, plain call)."""
    from covomix_tpu_torch.ops import vocoder_tail as VT

    tail = kind == "tail"
    packed = VT.pack_weights(up, blocks, post, (3, 7, 11), ((1, 3, 5),) * 3, x.dtype, x.device)
    kern = VT.TAIL if tail else VT.STAGE
    log_vocoder_plan(results, key, kern, x, packed)
    plain = (lambda: VT.fused_tail_plain(x, up, blocks, post)) if tail else (
        lambda: VT.fused_stage_plain(x, up, blocks))
    results[f"{key}_max_abs_err"] = vocoder_agreement(f"fused {kind} at {what}", x, kern(x, packed), plain())
    return (lambda: kern(x, packed)), plain


def time_vocoder(results, key, kind, x, up, blocks, post=None):
    """Kernel, plain version and the unfused generator ops of the stage
    (kind "stage") or tail ("tail") on input x [B, T, Cin] with the default
    taps, into results[f"{key}_ms"] etc.; the kernel's output on these inputs
    is held against the plain version's (hold_vocoder). No single PyTorch
    call computes either function, so there is no library yardstick. The
    bound counts the operations at the peak of x's type (bf16: tensor cores;
    f32: the f32 kernels' scalar FMAs)."""
    import torch

    tail = kind == "tail"
    b, t, cin = x.shape
    c = up["w"].shape[2]
    fused, plain = hold_vocoder(results, key, kind, x, up, blocks, post)
    ms = both_times(results, key, fused)
    results[f"{key}_plain_ms"] = cuda_time_ms(plain, iters=5)
    results[f"{key}_unfused_ms"] = cuda_time_ms(lambda: unfused_stage(x, up, blocks, post), iters=10)
    n_out = (2 if tail else 4) * b * t
    taps_up = 2 if tail else 1
    macs = n_out * (taps_up * cin * c + 126 * c * c + (7 * c if tail else 0))   # 126 = 6 convs x (3+7+11)
    w_bytes = ((4 * cin * c + 126 * c * c + (7 * c if tail else 0)) * x.element_size()
               + (19 * c + 1) * 4)
    nbytes = b * t * cin * x.element_size() + n_out * (4 if tail else c * x.element_size()) + w_bytes
    peak = H100_BF16_FLOPS if x.dtype == torch.bfloat16 else H100_F32_FLOPS
    bf, bb = 2 * macs / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    results[f"{key}_bound_ms"] = max(bf, bb)
    results[f"{key}_bound_by"] = "operations" if bf >= bb else "bytes"
    log(f"fused {kind} timing x{list(x.shape)} {str(x.dtype)[6:]}: kernel {ms:.4f} ms ("
        f"{results[f'{key}_device_ms']:.4f} behind a sleep), plain "
        f"{results[f'{key}_plain_ms']:.4f} ms, unfused generator ops {results[f'{key}_unfused_ms']:.4f} ms, "
        f"bound {results[f'{key}_bound_ms']:.4f} ms ({results[f'{key}_bound_by']}: {2 * macs / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB) -> {2 * macs / ms / 1e9:.1f} TFLOP/s")


def log_vocoder_plan(results, key, kern, x, packed):
    """The block plan the library gives a fused kernel on x (tile, blocks,
    waves on this card's SMs, shared memory) and, per MRF conv, the busiest
    warp's units against the mean over the 16 warps and the idlest warp's
    units (bf16 units: 16-row x 32-channel m-tiles; f32: one row x 8
    channels); into results[f"{key}_plan"]."""
    p = kern.plan(x, packed)
    ratios = [round(busiest / (units / 16), 3) for _, units, busiest, _ in p.convs]
    idlest = min(c[3] for c in p.convs)
    results[f"{key}_plan"] = {**p._asdict(), "unit_max_over_mean": ratios, "idlest_warp_units": idlest}
    log(f"fused {'tail' if kern.tail else 'stage'} plan x{list(x.shape)}: tile {p.tile}, {p.blocks} blocks = "
        f"{p.waves:.3f} waves, {p.smem} B shared, busiest warp / mean units per conv {ratios}, "
        f"idlest warp's units in any conv {idlest}")


def time_vocoder_t512(results):
    """Both kernels at B=1 and the Synthesizer's smallest bucket, 512 mel
    frames, bf16, on random inputs and weights."""
    import torch

    for kind, t in (("stage", 20 * 512 + 4), ("tail", 80 * 512 + 16)):
        up, blocks, post = vocoder_stage_params(500, kind == "tail", 7)
        x = torch.randn((1, t, up["w"].shape[1]), generator=torch.Generator(device="cuda").manual_seed(8),
                        device="cuda").to(torch.bfloat16)
        time_vocoder(results, f"{kind}_t512", kind, x, up, blocks, post)


# ---------------------------------------------------------------------------
# phase 4: full-width serving


def full_width_configs():
    from covomix_tpu_torch.models import acoustic as A, text2semantic as T, vocoder as V

    t2s = T.T2SConfig(dim=512, source_depth=4, target_depth=4, heads=8, dim_head=64,
                      num_text_tokens=30528, num_semantic_tokens=501, target_dim=1024, two_output=True)
    ac = A.AcousticConfig(dim_in=160, dim=1024, depth=8, heads=16, dim_head=64,
                          num_phoneme_tokens=502, mode="two_one")
    return t2s, ac, V.VocoderConfig()


def serving_inputs(b, prompt, text_len, cond_dim, seed):
    import numpy as np

    rs = np.random.RandomState(seed)
    return (rs.randint(1, 30000, (b, text_len)).astype(np.int32),
            rs.randint(0, 500, (b, prompt, 2)).astype(np.int32),
            (rs.randn(b, prompt, cond_dim) * 0.1).astype(np.float32))


def run_serving(results, batch=4, prompt=400, decode=512, timed=1):
    import torch
    from covomix_tpu_torch.models import acoustic as A, text2semantic as T, vocoder as V
    from covomix_tpu_torch.ops import flash_attention as FA
    from covomix_tpu_torch.serving import BatchedPipeline

    t2s_cfg, ac_cfg, voc_cfg = full_width_configs()
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.time()
    pipe = BatchedPipeline(T.init(g, t2s_cfg), t2s_cfg, A.init(g, ac_cfg), ac_cfg,
                           V.init_generator(g, voc_cfg), voc_cfg, decode_len=decode, cond_scale=0.7,
                           dtype=torch.bfloat16, min_length=decode, device="cuda")
    log(f"serving: full-width random weights built in {time.time() - t0:.1f} s")
    placed = pipe.place(*serving_inputs(batch, prompt, 64, ac_cfg.dim_in, 1))
    gen = torch.Generator(device="cuda").manual_seed(10)

    t0 = time.time()
    wav, res = pipe(gen, *placed)
    torch.cuda.synchronize()
    log(f"serving warm-up batch: {time.time() - t0:.3f} s")

    walls = []
    launches = []
    for _ in range(timed):
        FA.KERNEL.launches = FA.KERNEL.rotary_launches = 0
        t0 = time.time()
        wav, res = pipe(gen, *placed)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        launches.append(FA.KERNEL.launches)
        if FA.KERNEL.rotary_launches != FA.KERNEL.launches:
            raise AssertionError(f"{FA.KERNEL.rotary_launches} rotary pre-pass launches for {FA.KERNEL.launches} "
                                 f"forwards with rotary in a serving batch")
    expect = ac_cfg.depth * 16 * 2
    audio_s = batch * decode * 0.02
    wall = min(walls)
    log(f"serving B={batch} prompt={prompt} decode={decode} bf16: wall {walls} s, best {wall:.4f} s, "
        f"audio {audio_s:.2f} s, RTF {wall / audio_s:.5f}, flash launches per batch {launches}, "
        f"decode steps {res.num_steps}")
    if any(n != expect for n in launches):
        raise AssertionError(f"flash kernel launched {launches} times per batch, expected {expect}")
    if tuple(wav.shape) != (batch, V.output_length(voc_cfg, decode)) or not bool(torch.isfinite(wav).all()):
        raise AssertionError(f"bad wav: shape {tuple(wav.shape)}, finite {bool(torch.isfinite(wav).all())}")
    results.update(flash_launches=launches[0], serving_wall_s=wall, serving_rtf=wall / audio_s,
                   serving_models=(pipe.acoustic_params, pipe.vocoder_params),   # phase 13 serves with them
                   serving_t2s=pipe.t2s_params)                                  # phase 14 decodes with them
    results["serving_idle"] = traced_idle_share("serving batch", lambda: pipe(gen, *placed), wall)
    stages, valid = split_serving_batch(pipe, gen, placed)
    log("serving stage times (s): " + json.dumps(stages))
    results["stages"] = stages
    vrows = valid.tolist()
    return vrows + vrows   # the CFG-doubled batch the flow model attends over


def split_serving_batch(pipe, gen, placed):
    """The stages of one BatchedPipeline batch (bf16, two streams): the same
    calls as its __call__, each timed alone (host clock ended by a
    synchronize). Returns ({stage: s}, per-row valid frames of the flow)."""
    import torch
    from covomix_tpu_torch.models import acoustic as A, vocoder as V
    from covomix_tpu_torch.serving import pack_rows, slice_generated

    stages = {}
    text_ids, pt, pm, pl = placed

    def timed_stage(name, fn):
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.time() - t
        return out

    r = timed_stage("t2s_decode_s", lambda: pipe._gen(pipe.t2s_params, gen, text_ids))
    gl = torch.minimum(r.lengths, r.lengths2).to(torch.int32)
    ph, cond = timed_stage("pack_s", lambda: pack_rows(r.tokens, r.tokens2, gl, pt, pm, pl, True))
    mel = timed_stage("flow_s", lambda: A.sample(pipe.acoustic_params, pipe.acoustic_cfg, gen, ph, cond,
                                                 cond_scale=pipe.cond_scale, valid_len=pl + gl, dtype=pipe.dtype))
    timed_stage("vocoder_s", lambda: V.generator(pipe.vocoder_params, pipe.vocoder_cfg,
                                                 slice_generated(mel, pl, pipe.decode_len), dtype=pipe.dtype,
                                                 valid_len=gl))
    return stages, pl + gl


# ---------------------------------------------------------------------------
# phase 5: small f32 run, card vs CPU


def check_small_against_cpu():
    import numpy as np
    import torch
    from covomix_tpu_torch.models import acoustic as A, text2semantic as T, vocoder as V
    from covomix_tpu_torch.ops import flash_attention as FA
    from covomix_tpu_torch.serving import BatchedPipeline

    t2s_cfg = T.T2SConfig(dim=32, source_depth=1, target_depth=1, heads=2, dim_head=16,
                          num_text_tokens=200, target_dim=64, two_output=True)
    ac_cfg = A.AcousticConfig(dim_in=160, dim=64, depth=2, heads=2, dim_head=32, dim_phoneme_emb=16,
                              mode="two_one")
    voc_cfg = V.VocoderConfig(upsample_initial_channel=16)
    g = torch.Generator().manual_seed(3)
    params = (T.init(g, t2s_cfg), A.init(g, ac_cfg), V.init_generator(g, voc_cfg))
    b, prompt, decode = 2, 400, 112        # 512 frames: the flash kernel's threshold on the card
    text, pt, pm = serving_inputs(b, prompt, 8, 160, 4)
    plens = np.array([400, 250], np.int32)
    noise = torch.from_numpy(np.random.RandomState(5).randn(b, prompt + decode, 80).astype(np.float32))
    outs = []
    for dev in ("cuda", "cpu"):
        pipe = BatchedPipeline(params[0], t2s_cfg, params[1], ac_cfg, params[2], voc_cfg, decode_len=decode,
                               dtype=torch.float32, top_k_thres=1e-3, device=dev)   # k = 1: greedy
        before = FA.KERNEL.launches
        wav, res = pipe(torch.Generator(device=dev).manual_seed(0), text, pt, pm, prompt_lens=plens,
                        noise=noise.to(dev))
        outs.append((wav.cpu(), res.tokens.cpu(), res.tokens2.cpu(), FA.KERNEL.launches - before))
    (wc, t1c, t2c, nc), (wh, t1h, t2h, nh) = outs
    err = (wc - wh).abs().max().item()
    log(f"small f32 serving, card vs CPU: tokens equal {bool((t1c == t1h).all() and (t2c == t2h).all())}, "
        f"wav max_abs_err {err:.3e} (tol {SMALL_WAV_TOL:g}), flash launches card {nc} / cpu {nh}")
    if not (torch.equal(t1c, t1h) and torch.equal(t2c, t2h)):
        raise AssertionError("greedy tokens differ between the card and the CPU")
    if nc != ac_cfg.depth * 32 or nh != 0:
        raise AssertionError("the small card run did not go through the flash kernel")
    if not err <= SMALL_WAV_TOL:
        raise AssertionError(f"card and CPU wavs differ by {err}")


# ---------------------------------------------------------------------------
# phase 6: per-file generation through the dialogue CLI


def write_dialogue_assets(root, n_scripts=2, seed=0):
    """Full-width random checkpoints (.npz + .json config sidecars, written
    with the port's save_params) and `n_scripts` two-speaker scripts with
    `_1`/`_2` prompts of 400 frames: 8 s noise wavs and codes as strings."""
    import dataclasses

    import numpy as np
    import torch
    from covomix_tpu_torch.audio import save_wav
    from covomix_tpu_torch.checkpoint.io import save_params
    from covomix_tpu_torch.models import acoustic as A, text2semantic as T, vocoder as V

    g = torch.Generator(device="cuda").manual_seed(seed)
    for name, init, cfg in zip(("t2s", "acoustic", "vocoder"), (T.init, A.init, V.init_generator),
                               full_width_configs()):
        save_params(os.path.join(root, f"{name}.npz"), init(g, cfg), meta={"config": dataclasses.asdict(cfg)})
    os.makedirs(os.path.join(root, "texts"))
    os.makedirs(os.path.join(root, "prompts"))
    rs = np.random.RandomState(seed)
    for i in range(n_scripts):
        with open(os.path.join(root, "texts", f"dlg{i}.txt"), "w") as f:
            f.write(DIALOGUE_SCRIPT)
        for spk in (1, 2):
            base = os.path.join(root, "prompts", f"dlg{i}_{spk}")
            np.save(base + ".hubert_code.npy", rs.randint(0, 500, 400).astype(str))
            save_wav(base + ".wav", (rs.randn(8 * 8000) * 0.05).astype(np.float32), 8000)


PER_TURN_MODES = ("covosingle", "covosinx")   # one T2S decode per dialogue turn


def run_generation_cli(results, root, cli, mode, *, t2s="t2s.npz", acoustic="acoustic.npz", fuse_tail=True,
                       texts="texts", prompts="prompts", extra=(), key="dialogue"):
    """A generation CLI (`cli`: "dialogue" or "monologue") over the scripts
    in root/`texts` with the prompts in root/`prompts` and the checkpoints
    `t2s` / `acoustic` / vocoder.npz in `root`: full width, bf16, `mode`,
    with or without --fuse_tail, more flags `extra`. The launch counts are
    set to 0 just before and read just after; per call, flow_sample and
    vocode record their own launches. Gates per script: one T2S decode a
    turn in the per-turn modes' dialogues (one otherwise), one flow sample a
    turn in covosingle's (one otherwise), each flow 256 flash forwards and
    256 rotary pre-passes over at least the prompt's 400 frames, one vocode
    after each flow with one fused stage and one tail launch under
    --fuse_tail and none without, and an int16 wav of 160 samples per
    generated frame. Results go to results[f"{key}_*"]; returns
    [(Synthesizer, GenerateResult)] of every T2S decode, through `generate`
    or, with --speculative, `generate_speculative` (and then never the
    other)."""
    import numpy as np
    from scipy.io import wavfile
    from covomix_tpu_torch import dialogue_generation, monologue_generation, pipeline as P
    from covomix_tpu_torch.models import text2semantic as T
    from covomix_tpu_torch.ops import flash_attention as FA, vocoder_tail as VT

    calls = {"flow": [], "vocode": [], "steps": [], "script": [], "flow_s": [], "vocode_s": [], "decodes": []}
    speculative = "--speculative" in extra
    orig = (P.Synthesizer.flow_sample, P.Synthesizer.vocode, P.Synthesizer._decode, T.generate,
            VT.fused_stage, VT.fused_tail, getattr(P.Synthesizer, cli))     # the Synthesizer's method of each CLI
    inputs = {}      # the last vocode's fused-kernel inputs (default taps), for the timing phase

    def fused_stage(x, up_p, resblocks, kernels, dilations):
        inputs["stage"] = (x.contiguous().clone(), up_p, resblocks, None)
        return orig[4](x, up_p, resblocks, kernels, dilations)

    def fused_tail(x, up_p, resblocks, post_p, kernels, dilations):
        inputs["tail"] = (x.contiguous().clone(), up_p, resblocks, post_p)
        return orig[5](x, up_p, resblocks, post_p, kernels, dilations)

    def flow_sample(self, phoneme_ids, cond, generator, noise=None):
        n0, r0, t0 = FA.KERNEL.launches, FA.KERNEL.rotary_launches, time.time()
        out = orig[0](self, phoneme_ids, cond, generator, noise)   # numpy: the card has finished
        calls["flow"].append((len(calls["script"]), FA.KERNEL.launches - n0, FA.KERNEL.rotary_launches - r0,
                              len(phoneme_ids)))
        calls["flow_s"].append(time.time() - t0)
        return out

    def vocode(self, mel):
        s0, n0, t0 = VT.STAGE.launches, VT.TAIL.launches, time.time()
        wav = orig[1](self, mel)
        calls["vocode"].append((len(calls["script"]), VT.STAGE.launches - s0, VT.TAIL.launches - n0, len(mel),
                                len(wav)))
        calls["vocode_s"].append(time.time() - t0)
        return wav

    def script(self, *args, **kwargs):
        t0 = time.time()
        wav = orig[6](self, *args, **kwargs)          # numpy: the card has finished
        calls["script"].append((time.time() - t0, len(wav)))
        return wav

    def decode(self, text, generator):
        res = orig[2](self, text, generator)
        calls["steps"].append(res.num_steps)
        calls["decodes"].append((self, res, len(calls["script"])))
        return res

    def generate(*args, **kwargs):
        raise AssertionError("the sampling decode ran in a --speculative run")

    out = os.path.join(root, f"{key}_out")
    argv = ["--t2s_ckpt", os.path.join(root, t2s), "--acous_ckpt", os.path.join(root, acoustic),
            "--hifigan_ckpt", os.path.join(root, "vocoder.npz"), "--text_dir", os.path.join(root, texts),
            "--prompt_dir", os.path.join(root, prompts), "--saved_dir", out, "--mode", mode,
            *(["--fuse_tail"] if fuse_tail else []), "--device", "cuda", "--allow_fallback_vocab", *extra]
    (P.Synthesizer.flow_sample, P.Synthesizer.vocode, P.Synthesizer._decode, VT.fused_stage,
     VT.fused_tail) = (flow_sample, vocode, decode, fused_stage, fused_tail)
    setattr(P.Synthesizer, cli, script)
    if speculative:
        T.generate = generate
    FA.KERNEL.launches = FA.KERNEL.rotary_launches = VT.STAGE.launches = VT.TAIL.launches = 0
    try:
        t0 = time.time()
        (dialogue_generation if cli == "dialogue" else monologue_generation).main(argv)
        total = time.time() - t0
    finally:
        (P.Synthesizer.flow_sample, P.Synthesizer.vocode, P.Synthesizer._decode, T.generate, VT.fused_stage,
         VT.fused_tail) = orig[:6]
        setattr(P.Synthesizer, cli, orig[6])
    launches = {"flash": FA.KERNEL.launches, "rotary": FA.KERNEL.rotary_launches, "stage": VT.STAGE.launches,
                "tail": VT.TAIL.launches}
    what = f"{cli} CLI {mode}{' --fuse_tail' if fuse_tail else ''} {' '.join(extra)}".rstrip()
    log(f"{what}: {total:.2f} s for {len(calls['script'])} scripts incl. loading; per script (wall s, samples) "
        f"{calls['script']}; decode steps {calls['steps']}; flow (script, flash, pre-pass launches, frames) "
        f"{calls['flow']}; vocode (script, stage, tail launches, frames, samples) {calls['vocode']}; totals "
        f"{launches}")
    names = sorted(f[:-len(".txt")] for f in os.listdir(os.path.join(root, texts)) if f.endswith(".txt"))
    if not names or len(calls["script"]) != len(names):
        raise AssertionError(f"{what}: {len(calls['script'])} scripts synthesized of {names}")
    if any(synth.speculative != speculative for synth, _, _ in calls["decodes"]):
        raise AssertionError(f"{what}: the CLI's Synthesizer decoded with speculative != {speculative}")
    per_call = (1, 1) if fuse_tail else (0, 0)
    for i, name in enumerate(names):
        with open(os.path.join(root, texts, name + ".txt")) as f:
            turns = f.read().count("[spkchange]") + 1 if cli == "dialogue" else 1
        decodes = [d for d in calls["decodes"] if d[2] == i]
        flows = [c for c in calls["flow"] if c[0] == i]
        vocodes = [c for c in calls["vocode"] if c[0] == i]
        want = (turns if mode in PER_TURN_MODES else 1, turns if mode == "covosingle" else 1)
        if (len(decodes), len(flows)) != want or len(vocodes) != len(flows):
            raise AssertionError(f"{what} {name}: {len(decodes)} decodes, {len(flows)} flow samples, {len(vocodes)} "
                                 f"vocodes for {turns} turns (expected {want[0]} / {want[1]} / {want[1]})")
        for (_, flash, rotary, frames), (_, stage, tail, mel_frames, samples) in zip(flows, vocodes):
            if flash != 8 * 16 * 2 or rotary != flash or (stage, tail) != per_call:
                raise AssertionError(f"{what} {name}: per call {flash} flash and {rotary} pre-pass launches (expected "
                                     f"256), {stage} stage and {tail} tail launches (expected {per_call})")
            if frames < 400 or samples != 160 * mel_frames:
                raise AssertionError(f"{what} {name}: flow over {frames} frames, vocode {mel_frames} frames -> "
                                     f"{samples} samples")
        sr, wav = wavfile.read(os.path.join(out, f"{name}.wav"))
        frames = sum(c[3] for c in vocodes)
        if sr != 8000 or wav.dtype != np.int16 or len(wav) != 160 * frames or len(wav) != calls["script"][i][1]:
            raise AssertionError(f"{what} {name}.wav: {sr} Hz, {wav.dtype}, {len(wav)} samples, expected "
                                 f"{160 * frames}")
    n = len(calls["flow"])
    if launches != {"flash": 256 * n, "rotary": 256 * n, "stage": per_call[0] * n, "tail": per_call[1] * n}:
        raise AssertionError(f"{what}: launch totals {launches} do not add up over {n} flow samples")
    if not os.path.isfile(os.path.join(out, "config.txt")):
        raise AssertionError(f"{what}: the CLI wrote no config.txt")
    wall, samples = calls["script"][-1]        # the last script: an earlier one warmed the card up
    last = len(calls["script"]) - 1
    audio_s = samples / 8000
    stages = {"flow_s": sum(t for c, t in zip(calls["flow"], calls["flow_s"]) if c[0] == last),
              "vocode_s": sum(t for c, t in zip(calls["vocode"], calls["vocode_s"]) if c[0] == last)}
    stages["rest_s (prompts, T2S decode)"] = wall - sum(stages.values())
    results.update({f"{key}_launches": launches, f"{key}_wall_s": wall, f"{key}_audio_s": audio_s,
                    f"{key}_rtf": wall / audio_s, f"{key}_steps": calls["steps"][-1],
                    f"{key}_decode_steps": calls["steps"], f"{key}_flow_frames": calls["flow"][-1][3],
                    f"{key}_vocoder_inputs": inputs, f"{key}_stages": stages})
    log(f"per-file {what}, full width bf16: wall {wall:.4f} s for {audio_s:.2f} s of audio, RTF "
        f"{wall / audio_s:.5f}, T2S decode steps {calls['steps']}, stages of the last script (s) "
        f"{json.dumps(stages)}")
    return [(synth, res) for synth, res, _ in calls["decodes"]]


# ---------------------------------------------------------------------------
# phase 7b: small f32 Synthesizer run, card vs CPU


def check_small_synth_against_cpu(prompt_dir, mode="covomix"):
    """The Synthesizer's dialogue in `mode` with tiny T2S / acoustic models,
    greedy T2S, the same y0 on both sides, prompt mel from shared `.mel.npy`
    caches, f32, card vs CPU. covomix (CoMix T2S, VoMix) and covosingle
    (CoSingle T2S, VoSingle) with the full-width vocoder and fuse_tail, so
    that the fused kernels run on the card (the unfused generator on the
    CPU; SMALL_SYNTH_WAV_TOL); covosinx (CoSingle T2S, VoMix) exact, with
    phase 5's small vocoder, unfused on both sides (SMALL_WAV_TOL)."""
    import dataclasses
    import functools

    import numpy as np
    import torch
    from covomix_tpu_torch.audio import MelConfig, load_wav, mel_spectrogram
    from covomix_tpu_torch.data.tokenizer import load_covomix_tokenizer
    from covomix_tpu_torch.models import acoustic as A, text2semantic as T, vocoder as V
    from covomix_tpu_torch.ops import flash_attention as FA, vocoder_tail as VT
    from covomix_tpu_torch.pipeline import Synthesizer
    from covomix_tpu_torch.util.misc import round_up

    t2s_cfg = T.T2SConfig(dim=32, source_depth=1, target_depth=1, heads=2, dim_head=16,
                          num_text_tokens=30528, target_dim=64, two_output=True)
    ac_cfg = A.AcousticConfig(dim_in=160, dim=64, depth=2, heads=2, dim_head=32, dim_phoneme_emb=16,
                              mode="two_one")
    voc_cfg, fuse_tail, tol = V.VocoderConfig(), True, SMALL_SYNTH_WAV_TOL
    if mode in PER_TURN_MODES:
        t2s_cfg = dataclasses.replace(t2s_cfg, target_dim=32, two_output=False)
    if mode == "covosingle":
        ac_cfg = dataclasses.replace(ac_cfg, dim_in=80, mode="single")
    if mode == "covosinx":
        voc_cfg, fuse_tail, tol = V.VocoderConfig(upsample_initial_channel=16), False, SMALL_WAV_TOL
    g = torch.Generator().manual_seed(3)
    params = (T.init(g, t2s_cfg), A.init(g, ac_cfg), V.init_generator(g, voc_cfg))
    p1, p2 = (os.path.join(prompt_dir, f"dlg0_{spk}.hubert_code.npy") for spk in (1, 2))
    for p in (p1, p2):    # one prompt mel for both sides
        wav, _ = load_wav(p.replace(".hubert_code.npy", ".wav"), sr=8000)
        mel = mel_spectrogram(torch.as_tensor(wav)[None], MelConfig())[0].numpy()
        np.save(p.replace(".hubert_code.npy", ".mel.npy"), mel)
    max_len = 112                           # 400 + 112 = 512 frames: the flash kernel runs on the card
    outs = []
    for dev in ("cuda", "cpu"):
        synth = Synthesizer(params[0], t2s_cfg, params[1], ac_cfg, params[2], voc_cfg,
                            load_covomix_tokenizer(None, strict=False), dtype=torch.float32, fuse_tail=fuse_tail,
                            t2s_max_length=max_len, device=dev)
        tokens = []
        greedy = functools.partial(T.generate, cfg=t2s_cfg, max_length=max_len, dtype=torch.float32,
                                   top_k_thres=1e-3)        # k = 1

        def gen_fn(*args, _tokens=tokens, **kwargs):
            _tokens.append(greedy(*args, **kwargs))
            return _tokens[-1]

        synth._gen_fn = gen_fn
        synth.flow_sample = lambda ph, cond, gen, s=synth: Synthesizer.flow_sample(
            s, ph, cond, gen, noise=torch.from_numpy(np.random.RandomState(5).randn(
                1, max(s.bucket, round_up(len(ph), s.bucket)), 80).astype(np.float32)))
        before = (FA.KERNEL.launches, VT.STAGE.launches, VT.TAIL.launches)
        wav = synth.dialogue(mode, DIALOGUE_SCRIPT, p1, p2, torch.Generator(device=dev).manual_seed(0))
        after = (FA.KERNEL.launches, VT.STAGE.launches, VT.TAIL.launches)
        outs.append((wav, [(r.tokens.cpu(), r.tokens2.cpu()) for r in tokens],
                     [a - b for a, b in zip(after, before)]))
    (wc, tc, nc), (wh, th, nh) = outs
    same_tokens = len(tc) == len(th) and all(torch.equal(a, c) and torch.equal(b, d) for (a, b), (c, d) in zip(tc, th))
    err = float(np.abs(wc - wh).max()) if wc.shape == wh.shape else float("inf")
    log(f"small f32 Synthesizer {mode} ({'full-width vocoder, fuse_tail' if fuse_tail else 'small vocoder, exact'}),"
        f" card vs CPU: {len(tc)} decodes, tokens equal {same_tokens}, wav {wc.shape} max_abs_err {err:.3e} (tol "
        f"{tol:g}), (flash, stage, tail) launches card {nc} / cpu {nh}")
    if not same_tokens:
        raise AssertionError(f"{mode}: greedy tokens differ between the card and the CPU")
    fused = (nc[1] >= 1 and nc[2] >= 1) if fuse_tail else nc[1] == nc[2] == 0
    if nc[0] < 1 or not fused or any(nh):
        raise AssertionError(f"{mode}: the small card run did not go through the kernels, or the CPU run did")
    if not err <= tol:
        raise AssertionError(f"{mode}: card and CPU wavs differ by {err}")
    return err


# ---------------------------------------------------------------------------
# phase 8: full-width VoMix training through the training CLI


# the VoMix acoustic recipe (running_command/Acous_VoMix.sh) on one card, bf16
VOMIX_RECIPE = ["--format", "hubert_overlap_two_input_one_output", "--twocondition_oneoutput",
                "--CoVoMix_dim", "160", "--CoVoMix_dim_transformer", "1024", "--CoVoMix_depth", "8",
                "--CoVoMix_heads", "16", "--CoVoMix_num_phoneme_tokens", "502", "--cond_drop_prob", "0.3",
                "--random_mask", "--batch_size", "8", "--lr", "1e-4", "--lr_scheduler", "--bf16"]
TRAIN_STEPS = 12


def write_vomix_items(root, n, seed):
    """n random VoMix items in the hubert_overlap_two_input_one_output layout:
    u.mel.npy (mixed), u-A / u-B .mel.npy [80, ~1000] f32 and u-A / u-B
    .hubert_code.npy as string arrays."""
    import numpy as np

    rs = np.random.RandomState(seed)
    os.makedirs(root)
    for i in range(n):
        t = 960 + 7 * i
        base = os.path.join(root, f"u{i}")
        np.save(base + ".mel.npy", (rs.randn(80, t) * 2 - 5).astype(np.float32))
        for ch in "AB":
            np.save(f"{base}-{ch}.mel.npy", (rs.randn(80, t) * 2 - 5).astype(np.float32))
            np.save(f"{base}-{ch}.hubert_code.npy", rs.randint(0, 500, t).astype(str))


COUNTS = {"fwd": "launches", "fwd_lse": "lse_launches", "bwd_dq": "dq_launches", "bwd_dkv": "dkv_launches",
          "fwd_causal": "causal_launches", "fwd_lse_causal": "causal_lse_launches",
          "bwd_dq_causal": "causal_dq_launches", "bwd_dkv_causal": "causal_dkv_launches",
          "rotary": "rotary_launches"}


def flash_counts():
    """Every launch count of the flash kernels, by kernel."""
    from covomix_tpu_torch.ops import flash_attention as FA

    return {key: getattr(FA.KERNEL, attr) for key, attr in COUNTS.items()}


def launches(**nonzero):
    """A flash_counts()-shaped dict: the counts given, 0 for every other kernel."""
    return {key: nonzero.get(key, 0) for key in COUNTS}


def run_train_cli(argv, evaluate_name, steps_total, resume=True):
    """`covomix_tpu_torch.train.cli.main(argv)` for `steps_total` steps, then
    (with `resume`) with `--resume` for one more, with every optimizer step
    timed (host clock ended by a synchronize) and the eval
    `train.evaluate.<evaluate_name>` recorded, each with the flash launches
    it made. The launch counts are set to 0 just before and read just after.
    Returns (steps, evals, totals, peak GiB, seconds of the first run,
    seconds of the resumed one or None)."""
    import numpy as np
    import torch
    from covomix_tpu_torch.ops import flash_attention as FA
    from covomix_tpu_torch.train import cli, evaluate as E, loop

    steps, evals = [], []
    orig = (loop.make_train_step, getattr(E, evaluate_name))

    def make_train_step(loss_fn, cfg, **kw):
        step = orig[0](loss_fn, cfg, **kw)

        def timed_step(state, batch, generator):
            torch.cuda.synchronize()
            c0, t0 = flash_counts(), time.time()
            metrics = step(state, batch, generator)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])   # waits for the card
            torch.cuda.synchronize()
            steps.append({"ms": (time.time() - t0) * 1e3, "loss": loss, "grad_norm": gnorm,
                          "shapes": {k: tuple(v.shape) for k, v in batch.items()},
                          "launches": {k: v - c0[k] for k, v in flash_counts().items()}})
            return metrics

        return timed_step

    def evaluate(params, cfg, batches, generator, **kw):
        c0, t0 = flash_counts(), time.time()
        ev = orig[1](params, cfg, batches, generator, **kw)
        evals.append({"s": time.time() - t0, "batches": len(batches),
                      "rows": sum(len(next(iter(b.values()))) for b in batches), **ev,
                      "launches": {k: v - c0[k] for k, v in flash_counts().items()}})
        return ev

    loop.make_train_step = make_train_step
    setattr(E, evaluate_name, evaluate)
    for attr in COUNTS.values():
        setattr(FA.KERNEL, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.time()
        cli.main(argv + ["--max_steps", str(steps_total)])
        first_s = time.time() - t0
        resume_s = None
        if resume:
            t0 = time.time()
            cli.main(argv + ["--max_steps", str(steps_total + 1), "--resume"])
            resume_s = time.time() - t0
    finally:
        loop.make_train_step = orig[0]
        setattr(E, evaluate_name, orig[1])
    return steps, evals, flash_counts(), torch.cuda.max_memory_allocated() / 2 ** 30, first_s, resume_s


def check_steps(what, steps, per_step):
    """Every optimizer step logged, with a finite loss and grad norm and
    exactly the flash launches `per_step`."""
    import numpy as np

    for i, s in enumerate(steps):
        log(f"{what} step {i + 1}: {s['ms']:.1f} ms, batch {s['shapes']}, loss {s['loss']:.5f}, "
            f"grad_norm {s['grad_norm']:.4f}, launches {s['launches']}")
        if not (np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])):
            raise AssertionError(f"{what} step {i + 1}: loss {s['loss']}, grad_norm {s['grad_norm']}")
        if s["launches"] != per_step:
            raise AssertionError(f"{what} step {i + 1}: launches {s['launches']} (expected {per_step})")


def check_train_run(what, steps, evals, ckpt, steps_total, rows, per_step, eval_launches):
    """The checks both training runs share: finite loss and grad norm every
    step, exactly `per_step` flash launches every step, steps_total + 1 steps
    over the run and its resume, one eval over `rows` dev files with a finite
    l2 and `eval_launches`, the top-k save and the resumed checkpoint.
    Returns the median ms per step over steps 3..steps_total."""
    import numpy as np

    check_steps(what, steps, per_step)
    if len(steps) != steps_total + 1:
        raise AssertionError(f"{len(steps)} optimizer steps over the run and its resume, expected "
                             f"{steps_total} + 1: the resume did not start from step {steps_total}")
    log(f"{what} eval: {evals}")
    if len(evals) != 1 or evals[0]["rows"] != rows or not np.isfinite(evals[0]["l2"]):
        raise AssertionError(f"expected one eval over the {rows} dev files with a finite l2, got {evals}")
    if evals[0]["launches"] != eval_launches:
        raise AssertionError(f"the eval launched {evals[0]['launches']}, expected {eval_launches}")
    with open(os.path.join(ckpt, "topk.json")) as f:
        topk = json.load(f)
    with np.load(os.path.join(ckpt, f"step_{steps_total + 1:08d}", "state.npz")) as z:
        counters = (int(z["step"]), int(z["adam_step"]), int(z["ema_num_updates"]))
    log(f"checkpoints {sorted(os.listdir(ckpt))}, topk.json {topk}, step {steps_total + 1} counters {counters}")
    if (sorted(os.listdir(ckpt)) != [f"step_{steps_total:08d}", f"step_{steps_total + 1:08d}", "topk.json"]
            or topk["best_step"] != steps_total or counters != (steps_total + 1,) * 3):
        raise AssertionError("the top-k save, the resume or its checkpoint is not as expected")
    ms = sorted(s["ms"] for s in steps[2:steps_total])
    return ms[len(ms) // 2] if len(ms) % 2 else (ms[len(ms) // 2 - 1] + ms[len(ms) // 2]) / 2


def run_training(results, root):
    """`covomix_tpu_torch.train.cli.main` with the VoMix recipe at full width
    (B=8, items cropped to 800 frames and bucketed to 832), bf16, on 24 train
    and 8 dev items: TRAIN_STEPS steps with one eval on the 8 dev files and
    its top-k save, then `--resume` for one more step. Every optimizer step
    must launch the forward with lse, dQ and dK/dV 8 times each (8 layers)
    and nothing else, the eval's sampler only the forward without lse."""
    train_dir, dev_dir, logs = (os.path.join(root, d) for d in ("train", "dev", "logs"))
    t0 = time.time()
    write_vomix_items(train_dir, 24, 0)
    write_vomix_items(dev_dir, 8, 1)
    log(f"training data: 24 train + 8 dev random VoMix items written in {time.time() - t0:.1f} s")
    argv = ["--base_dir", train_dir, "--dev_base_dir", dev_dir, *VOMIX_RECIPE, "--device", "cuda",
            "--log_every", "1", "--eval_every", str(TRAIN_STEPS), "--num_eval_files", "8", "--ckpt_every", "1000",
            "--no_wandb", "--log_dir", logs, "--run_name", "vomix", "--seed", "0"]
    steps, evals, totals, peak_gb, first_s, resume_s = run_train_cli(argv, "evaluate_acoustic", TRAIN_STEPS)
    per_step = launches(fwd_lse=8, bwd_dq=8, bwd_dkv=8, rotary=8)   # the VoMix layers take rotary
    bad = [s["shapes"]["x"] for s in steps if s["shapes"]["x"] != (8, 832, 240)]
    if bad:
        raise AssertionError(f"VoMix batches {bad}, expected (8, 832, 240)")
    median = check_train_run("VoMix train", steps, evals, os.path.join(logs, "vomix", "checkpoints"), TRAIN_STEPS,
                             8, per_step, launches(fwd=256 * evals[0]["batches"], rotary=256 * evals[0]["batches"]))
    expect = {k: v * len(steps) for k, v in per_step.items()}
    expect["fwd"] = evals[0]["launches"]["fwd"]
    expect["rotary"] += evals[0]["launches"]["rotary"]
    if totals != expect:
        raise AssertionError(f"launch totals {totals} over the training run, expected {expect}")
    results.update(train_launches=totals, train_steps=len(steps), train_step_ms=median,
                   train_samples_per_s=8 / (median / 1e3), train_peak_gb=peak_gb)
    log(f"full-width VoMix training (bf16, B=8, T=832): median {median:.2f} ms per optimizer step over steps 3-"
        f"{TRAIN_STEPS}, {8 / (median / 1e3):.2f} samples/s, peak device memory {peak_gb:.2f} GiB; run "
        f"{first_s:.1f} s incl. init and {TRAIN_STEPS} steps, eval {evals[0]['s']:.2f} s, resume run "
        f"{resume_s:.1f} s; launch totals {totals}")
    return train_dir


def split_training_step(results, key, params, loss_fn, batch, n=5, idle_key=None):
    """Where an optimizer step's time goes at full width: the loss forward,
    the backward and the optimizer (Adam + EMA), each ended by a synchronize,
    the median of `n` steps after one warm-up, into results[key]. With
    `idle_key`, one more whole step traced: its device idle share into
    results[idle_key]."""
    import torch
    from covomix_tpu_torch.train import loop

    gen = torch.Generator(device="cuda").manual_seed(5)
    tcfg = loop.TrainConfig(lr=1e-4)
    state = loop.init_train_state(params, tcfg)
    batch = loop.to_device(batch, "cuda")
    parts = {"forward": [], "backward": [], "optimizer": []}
    for i in range(n + 1):
        times = []
        torch.cuda.synchronize()
        t0 = time.time()
        loss = loss_fn(state.params, batch, gen)
        torch.cuda.synchronize()
        times.append(time.time())
        loss.backward()
        torch.cuda.synchronize()
        times.append(time.time())
        state.optimizer.step()
        loop.ema_update(state.ema_params, state.params, state.ema_num_updates, tcfg.ema_decay)
        state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        times.append(time.time())
        if i:
            for part, a, b in zip(parts, [t0] + times[:2], times):
                parts[part].append((b - a) * 1e3)
    split = results[key] = {k: sorted(v)[len(v) // 2] for k, v in parts.items()}
    if idle_key is not None:
        def whole_step():
            loss_fn(state.params, batch, gen).backward()
            state.optimizer.step()
            loop.ema_update(state.ema_params, state.params, state.ema_num_updates, tcfg.ema_decay)
            state.optimizer.zero_grad(set_to_none=True)

        results[idle_key] = traced_idle_share(f"{key} step", whole_step, sum(split.values()) / 1e3)
    log(f"{key}: optimizer step split at full width, batch {[tuple(v.shape) for v in batch.values()]} "
        f"(median of {n}, ms): {json.dumps(split)}")


def split_vomix_step(results, train_dir, key="train_split_ms", f32=False, idle_key=None):
    import torch
    from covomix_tpu_torch.data.datasets import CoVoMixDataset, collate_acoustic
    from covomix_tpu_torch.models import acoustic as A
    from covomix_tpu_torch.train import loop

    cfg = A.AcousticConfig(dim_in=160, dim=1024, depth=8, heads=16, dim_head=64, num_phoneme_tokens=502,
                           mode="two_one")
    ds = CoVoMixDataset(train_dir, format="hubert_overlap_two_input_one_output", random_mask=True)
    split_training_step(results, key, A.init(torch.Generator(device="cuda").manual_seed(5), cfg),
                        loop.acoustic_loss_fn(cfg, cond_drop_prob=0.3, dtype=torch.float32 if f32 else torch.bfloat16),
                        collate_acoustic([ds[i] for i in range(8)]), idle_key=idle_key)


def check_small_training_against_cpu(single=False, adam_bound=False):
    """Two optimizer steps of a tiny f32 VoMix model (with `single`, VoSingle:
    80-d, one phoneme stream, the batch's end mask) (dh 16, T = 576 >= 512,
    so the card takes the flash kernels) on the card and on the CPU (einsum
    attention there), TF32 off, the same batches and the same draws (one CPU
    generator: the loss draws on the generator's device); held by
    hold_small_steps."""
    import numpy as np
    import torch
    from covomix_tpu_torch.models import acoustic as A
    from covomix_tpu_torch.train import loop
    from covomix_tpu_torch.util.misc import tree_map

    cfg = A.AcousticConfig(dim_in=80 if single else 160, dim=32, depth=2, heads=2, dim_head=16, dim_phoneme_emb=16,
                           mode="single" if single else "two_one")
    tcfg = loop.TrainConfig(lr=1e-3, use_lr_schedule=True, steps_per_epoch=1, wake_up_epochs=2, grad_clip=1.0)
    rs = np.random.RandomState(9)
    lo, hi = (200, 576) if single else (100, 400)      # VoSingle: the end span its items carry
    batches = []
    for _ in range(2):
        mask = np.zeros((2, 576), bool)
        mask[:, lo:hi] = True
        batches.append({"x": rs.randn(2, 576, 80 if single else 240).astype(np.float32),
                        "phonemes": rs.randint(0, 502, (2, 576) if single else (2, 576, 2)).astype(np.int32),
                        "mask": mask})
    init = A.init(torch.Generator().manual_seed(0), cfg)
    runs = {}
    for dev in ("cuda", "cpu"):
        state = loop.init_train_state(tree_map(lambda p: p.clone().to(dev), init), tcfg)
        step = loop.make_train_step(loop.acoustic_loss_fn(cfg, cond_drop_prob=0.3), tcfg)
        gen = torch.Generator().manual_seed(1)
        c0 = flash_counts()
        losses = [float(step(state, b, gen)["loss"]) for b in batches]
        runs[dev] = (losses, tree_map(lambda p: p.detach().cpu(), state.params),
                     {k: v - c0[k] for k, v in flash_counts().items()})
    return hold_small_steps(f"small f32 {'VoSingle' if single else 'VoMix'} training", runs,
                            launches(fwd_lse=4, bwd_dq=4, bwd_dkv=4), tcfg, adam_bound)


def hold_small_steps(what, runs, launched, tcfg, adam_bound):
    """Two small f32 steps on the card against the same on the CPU (`runs`:
    {device: (losses, parameters, launches)}): the losses within
    SMALL_TRAIN_LOSS_TOL relative, the card's launches `launched` and the
    CPU's none, the parameters within SMALL_TRAIN_PARAM_TOL or, with
    `adam_bound`, by param_agreement at the two steps' learning rates (Adam's
    bound; module constants). Returns the errors."""
    import torch
    from covomix_tpu_torch.train import loop
    from covomix_tpu_torch.util.misc import tree_leaves

    (lc, pc, nc), (lh, ph, nh) = runs["cuda"], runs["cpu"]
    flat_c, flat_h = (torch.cat([p.reshape(-1) for p in tree_leaves(t)]) for t in (pc, ph))
    out = {"loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(lc, lh)),
           "param_max_abs_err": float((flat_c - flat_h).abs().max())}
    if adam_bound:
        schedule = loop.reference_lr_schedule(tcfg)
        out["adam"] = agree = param_agreement(flat_c, flat_h, [schedule(0), schedule(1)], "f32")
        params_ok = agree["max_abs_err"] <= agree["bound"] and agree["tight_share"] <= DP_TIGHT_SHARE
        rule = f"Adam's bound: {json.dumps(agree)}, tight share at most {DP_TIGHT_SHARE:g}"
    else:
        params_ok, rule = out["param_max_abs_err"] <= SMALL_TRAIN_PARAM_TOL, f"tol {SMALL_TRAIN_PARAM_TOL:g}"
    log(f"{what}, card vs CPU, 2 steps: losses {lc} / {lh} (max rel err {out['loss_rel_err']:.3e}, tol "
        f"{SMALL_TRAIN_LOSS_TOL:g}), params max_abs_err {out['param_max_abs_err']:.3e} ({rule}), launches card "
        f"{nc} / cpu {nh}")
    if nc != launched or any(nh.values()):
        raise AssertionError(f"{what}: the small card run did not go through the kernels, or the CPU run did")
    if not (out["loss_rel_err"] <= SMALL_TRAIN_LOSS_TOL and params_ok):
        raise AssertionError(f"{what}: card and CPU training steps differ")
    return out


# ---------------------------------------------------------------------------
# phase 9: full-width CoMix T2S training through the training CLI


# the CoMix T2S recipe (running_command/T2S_CoMix.sh) on one card, bf16, with
# the tokenizer's fallback vocab (no BERT vocab.txt in the checkout)
COMIX_T2S_RECIPE = ["--format", "text2semantic_2output", "--text2semantic", "--text2semantic_two_output",
                    "--allow_fallback_vocab", "--CoVoMix_dim_transformer", "512", "--target_transformer_dim", "1024",
                    "--text2semantic_tokens", "501", "--text2semantic_source_depth", "4",
                    "--text2semantic_target_depth", "4", "--text2semantic_head", "8", "--batch_size", "6",
                    "--lr", "1e-4", "--lr_scheduler", "--bf16"]
T2S_WORDS = ("hello there how are you doing today i am fine thank you good to hear see you soon yes no "
             "okay right sure well maybe later").split()


def write_t2s_items(root, n, seed, pairs=True):
    """n random CoMix T2S items: `u<i>.hubert_code.npy` of 520-1000 codes (as
    strings) beside `u<i>.txt` of 4-12 words, every fourth one a `_1` / `_2`
    two-speaker pair (with `pairs`; without, CoSingle items, one speaker
    each). The texts stay short enough that a 20 % concatenation
    of two is far below 512 ids of the fallback vocab, so the encoder stays on
    layers.attend; the codes are long enough that every decoder runs from 578
    positions on, so every layer takes the causal flash kernels."""
    import numpy as np

    rs = np.random.RandomState(seed)
    os.makedirs(root)
    for i in range(n):
        t = int(rs.randint(520, 1001))
        base = os.path.join(root, f"u{i}")
        if pairs and i % 4 == 3:
            np.save(base + "_1.hubert_code.npy", rs.randint(0, 500, t).astype(str))
            np.save(base + "_2.hubert_code.npy", rs.randint(0, 500, t - int(rs.randint(0, 60))).astype(str))
        else:
            np.save(base + ".hubert_code.npy", rs.randint(0, 500, t).astype(str))
        with open(base + ".txt", "w") as f:
            f.write(" ".join(rs.choice(T2S_WORDS, int(rs.randint(4, 13)))))


def run_t2s_training(results, root):
    """`covomix_tpu_torch.train.cli.main` with the CoMix T2S recipe at full
    width (dim 512, target_dim 1024, 4 + 4 layers, 8 heads, two streams, B=6),
    bf16, on 24 train and 6 dev random items: TRAIN_STEPS steps with one eval
    (a 512-step decode of the EMA parameters on the 6 dev files) and its
    top-k save, then `--resume` for one more step. Every optimizer step must
    launch the causal forward with lse, causal dQ and causal dK/dV 4 times
    each (the 4 decoder layers) and no other flash kernel; the eval's decode
    none."""
    train_dir, dev_dir, logs = (os.path.join(root, d) for d in ("train", "dev", "logs"))
    write_t2s_items(train_dir, 24, 0)
    write_t2s_items(dev_dir, 6, 1)
    argv = ["--base_dir", train_dir, "--dev_base_dir", dev_dir, *COMIX_T2S_RECIPE, "--device", "cuda",
            "--log_every", "1", "--eval_every", str(TRAIN_STEPS), "--num_eval_files", "6", "--ckpt_every", "1000",
            "--no_wandb", "--log_dir", logs, "--run_name", "comix_t2s", "--seed", "0"]
    steps, evals, totals, peak_gb, first_s, resume_s = run_train_cli(argv, "evaluate_t2s", TRAIN_STEPS)
    per_step = launches(fwd_lse_causal=4, bwd_dq_causal=4, bwd_dkv_causal=4)
    shapes = [s["shapes"]["semantic_ids"] for s in steps]
    if any(sh[0] != 6 or sh[2] != 2 or not 576 <= sh[1] <= 2048 for sh in shapes):
        raise AssertionError(f"T2S batches {shapes}: expected [6, 576..2048, 2] semantic ids")
    median = check_train_run("T2S train", steps, evals, os.path.join(logs, "comix_t2s", "checkpoints"),
                             TRAIN_STEPS, 6, per_step, launches())
    if totals != {k: v * len(steps) for k, v in per_step.items()}:
        raise AssertionError(f"launch totals {totals} over the T2S training run")
    results.update(t2s_launches=totals, t2s_steps=len(steps), t2s_step_ms=median,
                   t2s_samples_per_s=6 / (median / 1e3), t2s_peak_gb=peak_gb)
    decoder_t = sorted(sh[1] + 2 for sh in shapes)
    log(f"full-width CoMix T2S training (bf16, B=6, decoder T {decoder_t[0]}-{decoder_t[-1]}): median "
        f"{median:.2f} ms per optimizer step over steps 3-{TRAIN_STEPS}, {6 / (median / 1e3):.2f} samples/s, "
        f"peak device memory {peak_gb:.2f} GiB; run {first_s:.1f} s incl. init and {TRAIN_STEPS} steps, eval "
        f"{evals[0]['s']:.2f} s, resume run {resume_s:.1f} s; launch totals {totals}")


def split_t2s_step(results, key="t2s_split_ms", f32=False):
    """The T2S step's split at the shape the causal kernels are timed at: a
    random batch of 6 texts of 64 ids and semantic targets bucketed to 1024
    (decoder T = 1026), bf16 or with `f32` in f32."""
    import numpy as np
    import torch
    from covomix_tpu_torch.models import text2semantic as T
    from covomix_tpu_torch.train import loop

    cfg = T.T2SConfig(dim=512, source_depth=4, target_depth=4, heads=8, dim_head=64, num_text_tokens=30528,
                      num_semantic_tokens=501, target_dim=1024, two_output=True)
    rs = np.random.RandomState(6)
    batch = {"text_ids": rs.randint(1, 180, (6, 64)).astype(np.int32),
             "semantic_ids": rs.randint(0, 500, (6, 1024, 2)).astype(np.int32)}
    split_training_step(results, key, T.init(torch.Generator(device="cuda").manual_seed(5), cfg),
                        loop.t2s_loss_fn(cfg, dtype=torch.float32 if f32 else torch.bfloat16), batch)


def time_flash_causal(results, b=6, h=8, t=1026, dh=64):
    """The causal forward with lse, dQ and dK/dV at the T2S step's shape (B=6,
    8 heads, targets bucketed to 1024 -> decoder T 1026, bf16, no rotary, all
    keys live), each beside its plain version, its bound and one PyTorch call
    of the same function: SDPA with is_causal=True for the forward, its
    gradient (dQ, dK and dV in one call) for the pair. The bound counts the
    live pairs B*H*T(T+1)/2 at 4, 6 and 8 dh operations each. The outputs on
    the timed inputs are held against the plain versions'."""
    import torch
    import torch.nn.functional as F
    from covomix_tpu_torch.ops import flash_attention as FA

    bf = torch.bfloat16
    q, k, v, valid_arr, _ = flash_inputs(b, h, t, dh, bf, 701, t, False)
    dout = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(702), device="cuda").to(bf)
    log(f"causal flash kernels at the timed inputs [{b},{h},{t},{dh}] bf16:")
    out, lse = FA.KERNEL(q, k, v, valid_arr, None, return_lse=True, causal=True)
    ref, ref_lse = FA.flash_attention_plain(q, k, v, valid_arr, None, True, return_lse=True)
    results["fwd_lse_causal_max_abs_err"] = max(flash_agreement("out", out, ref, BF16_TOL),
                                                flash_agreement("lse", lse, ref_lse, LSE_TOL))
    bwd = (q, k, v, dout, ref_lse, FA.flash_delta(dout, ref), valid_arr, True)
    results["bwd_dq_causal_max_abs_err"] = flash_agreement("dq", FA.KERNEL.bwd_dq(*bwd),
                                                           FA.flash_bwd_dq_plain(*bwd), BWD_BF16_TOL)
    (dk, dv), (dk_p, dv_p) = FA.KERNEL.bwd_dkv(*bwd), FA.flash_bwd_dkv_plain(*bwd)
    results["bwd_dkv_causal_max_abs_err"] = max(flash_agreement("dk", dk, dk_p, BWD_BF16_TOL),
                                                flash_agreement("dv", dv, dv_p, BWD_BF16_TOL))
    del out, ref, dk, dv, dk_p, dv_p
    timed = {
        "fwd_lse_causal": (lambda: FA.KERNEL(q, k, v, valid_arr, None, return_lse=True, causal=True),
                           lambda: FA.flash_attention_plain(q, k, v, valid_arr, None, True, return_lse=True)),
        "bwd_dq_causal": (lambda: FA.KERNEL.bwd_dq(*bwd), lambda: FA.flash_bwd_dq_plain(*bwd)),
        "bwd_dkv_causal": (lambda: FA.KERNEL.bwd_dkv(*bwd), lambda: FA.flash_bwd_dkv_plain(*bwd)),
    }
    for key, (kern, plain) in timed.items():
        both_times(results, key, kern)
        results[f"{key}_plain_ms"] = cuda_time_ms(plain, iters=5)
    noncausal = cuda_time_ms(lambda: FA.KERNEL(q, k, v, valid_arr, None, return_lse=True), behind_sleep=True)
    log(f"forward with lse at [{b},{h},{t},{dh}] bf16 behind a sleep: causal "
        f"{results['fwd_lse_causal_device_ms']:.4f} ms, non-causal {noncausal:.4f} ms")
    both_times(results, "fwd_lse_causal_library", lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=True)
    both_times(results, "bwd_causal_library", lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True))
    for key in ("bwd_dq_causal", "bwd_dkv_causal"):   # one call computes dQ, dK and dV
        results[f"{key}_library_ms"] = results["bwd_causal_library_ms"]
        results[f"{key}_library_device_ms"] = results["bwd_causal_library_device_ms"]
    del o, leaves

    n, rows = b * h * t * dh * 2, b * h * t * 4
    pairs = b * h * t * (t + 1) / 2                      # live (query, key) pairs, all keys valid
    work = {"fwd_lse_causal": (4.0 * dh * pairs, 4 * n + rows),      # q,k,v,out; lse
            "bwd_dq_causal": (6.0 * dh * pairs, 5 * n + 2 * rows),   # q,k,v,dO,dq; lse,delta
            "bwd_dkv_causal": (8.0 * dh * pairs, 6 * n + 2 * rows)}  # q,k,v,dO,dk,dv; lse,delta
    for key, (flops, nbytes) in work.items():
        bound_and_log(results, key, [b, h, t, dh], flops, nbytes + valid_arr.numel() * 4)
    log_backward_pair(results, "_causal", [b, h, t, dh])


def check_small_t2s_training_against_cpu(two_output=True, adam_bound=False):
    """Two optimizer steps of a tiny f32 CoMix T2S model (without
    `two_output`, CoSingle: one output stream, target dim = dim) (dh 16, 2
    decoder layers, targets of 512 -> decoder T 514, so the card takes the
    causal flash kernels) on the card and on the CPU (layers.attend there),
    TF32 off, the same batches; held by hold_small_steps."""
    import numpy as np
    import torch
    from covomix_tpu_torch.models import text2semantic as T
    from covomix_tpu_torch.train import loop
    from covomix_tpu_torch.util.misc import tree_map

    cfg = T.T2SConfig(dim=32, source_depth=1, target_depth=2, heads=2, dim_head=16, num_text_tokens=200,
                      target_dim=64 if two_output else 32, two_output=two_output)
    tcfg = loop.TrainConfig(lr=1e-3, use_lr_schedule=True, steps_per_epoch=1, wake_up_epochs=2, grad_clip=1.0)
    rs = np.random.RandomState(9)
    batches = []
    for _ in range(2):
        text = rs.randint(1, 200, (2, 16)).astype(np.int32)
        text[1, 9:] = 0
        sem = rs.randint(0, 500, (2, 512, 2) if two_output else (2, 512)).astype(np.int32)
        sem[1, 400:] = 501
        batches.append({"text_ids": text, "semantic_ids": sem})
    init = T.init(torch.Generator().manual_seed(0), cfg)
    runs = {}
    for dev in ("cuda", "cpu"):
        state = loop.init_train_state(tree_map(lambda p: p.clone().to(dev), init), tcfg)
        step = loop.make_train_step(loop.t2s_loss_fn(cfg), tcfg)
        c0 = flash_counts()
        losses = [float(step(state, b, None)["loss"]) for b in batches]
        runs[dev] = (losses, tree_map(lambda p: p.detach().cpu(), state.params),
                     {k: v - c0[k] for k, v in flash_counts().items()})
    return hold_small_steps(f"small f32 {'CoMix' if two_output else 'CoSingle'} T2S training", runs,
                            launches(fwd_lse_causal=4, bwd_dq_causal=4, bwd_dkv_causal=4), tcfg, adam_bound)


# ---------------------------------------------------------------------------
# phase 9b: full-width f32 training, the recipes' own precision


F32_TRAIN_STEPS = 8
F32_CELLS = ("vomix", "t2s")


def run_f32_training(results, root, cell):
    """`covomix_tpu_torch.train.cli.main` with the VoMix (cell "vomix") or
    CoMix T2S ("t2s") recipe as running_command/ gives it, without --bf16 (the
    recipes train in f32), at full width on the items phases 8 / 9 write (24
    train items): F32_TRAIN_STEPS optimizer steps, no eval, no resume (the
    bf16 phases cover those). Every VoMix step must launch exactly 8 f32
    forwards with lse, 8 dQ and 8 dK/dV (and no rotary pre-pass: the f32
    kernels take q and k rotated, dq and dk through the tables), every T2S
    step 4 causal ones of each, nothing else; finite losses. Then the step's
    forward / backward / optimizer split in f32 (VoMix at B=8, T=832; T2S at
    decoder T 1026). Logs the median ms per step over steps 3-8, samples/s,
    the split and the peak device memory into results[f"{cell}_f32_*"]."""
    train_dir, logs = os.path.join(root, "train"), os.path.join(root, "logs")
    if cell == "vomix":
        write_vomix_items(train_dir, 24, 0)
        recipe, b, evaluate_name = VOMIX_RECIPE, 8, "evaluate_acoustic"
        per_step = launches(fwd_lse=8, bwd_dq=8, bwd_dkv=8)
    else:
        write_t2s_items(train_dir, 24, 0)
        recipe, b, evaluate_name = COMIX_T2S_RECIPE, 6, "evaluate_t2s"
        per_step = launches(fwd_lse_causal=4, bwd_dq_causal=4, bwd_dkv_causal=4)
    argv = ["--base_dir", train_dir, "--dev_base_dir", train_dir, *[a for a in recipe if a != "--bf16"],
            "--device", "cuda", "--log_every", "1", "--num_eval_files", "0", "--ckpt_every", "1000", "--no_wandb",
            "--log_dir", logs, "--run_name", f"{cell}_f32", "--seed", "0"]
    steps, evals, totals, peak_gb, first_s, _ = run_train_cli(argv, evaluate_name, F32_TRAIN_STEPS, resume=False)
    what = f"{cell} f32 train"
    check_steps(what, steps, per_step)
    if len(steps) != F32_TRAIN_STEPS or evals or totals != {key: n * F32_TRAIN_STEPS for key, n in per_step.items()}:
        raise AssertionError(f"{what}: {len(steps)} steps, {len(evals)} evals, launch totals {totals}")
    ms = sorted(st["ms"] for st in steps[2:])
    median = (ms[len(ms) // 2 - 1] + ms[len(ms) // 2]) / 2
    if cell == "vomix":
        split_vomix_step(results, train_dir, f"{cell}_f32_split_ms", f32=True)
    else:
        split_t2s_step(results, f"{cell}_f32_split_ms", f32=True)
    results.update({f"{cell}_f32_launches": totals, f"{cell}_f32_steps": len(steps), f"{cell}_f32_step_ms": median,
                    f"{cell}_f32_samples_per_s": b / (median / 1e3), f"{cell}_f32_peak_gb": peak_gb})
    shapes = sorted({st["shapes"]["x" if cell == "vomix" else "semantic_ids"] for st in steps})
    log(f"full-width {cell} training in f32 (B={b}, batches {shapes}): median {median:.2f} ms per optimizer step "
        f"over steps 3-{F32_TRAIN_STEPS}, {b / (median / 1e3):.2f} samples/s, peak device memory {peak_gb:.2f} GiB, "
        f"split {json.dumps(results[f'{cell}_f32_split_ms'])}; run {first_s:.1f} s incl. init and "
        f"{F32_TRAIN_STEPS} steps; launch totals {totals}")


# ---------------------------------------------------------------------------
# phase 10: the released checkpoint formats, converted and served directly


def zero_counts():
    """Every launch count of the flash and fused vocoder kernels set to 0."""
    from covomix_tpu_torch.ops import flash_attention as FA, vocoder_tail as VT

    for attr in COUNTS.values():
        setattr(FA.KERNEL, attr, 0)
    VT.STAGE.launches = VT.TAIL.launches = 0


def write_torch_checkpoints(root):
    """Full-width files in the reference's formats, written from the trees of
    the `.npz` checkpoints in `root` by tests/_torch_ckpt.py (the inverse of
    torch_convert): Lightning `.ckpt` files of the CoMix T2S and the VoMix
    model (hyper_parameters, the raw weights + 1 in `state_dict`, the tree as
    the EMA shadow) and a weight-normed HiFi-GAN `g_<step>` with the
    vocoder_config.json beside it, under `root`/torch. Each is converted back
    by `python -m covomix_tpu_torch.convert_checkpoint` (three processes at
    once, CPU only) and every converted leaf held to its source: the T2S and
    acoustic trees (linear, embedding and EMA-swapped leaves) bit for bit,
    the folded vocoder weights within CKPT_WN_RTOL relative. Returns
    {kind: path of the torch-format file}."""
    import numpy as np
    from covomix_tpu_torch.checkpoint.io import load_params
    from covomix_tpu_torch.util.misc import named_leaves

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import _torch_ckpt as CK

    t2s_cfg, ac_cfg, voc_cfg = full_width_configs()
    tdir = os.path.join(root, "torch")
    os.makedirs(tdir)
    paths = {"t2s": os.path.join(tdir, "t2s.ckpt"), "acoustic": os.path.join(tdir, "acoustic.ckpt"),
             "vocoder": os.path.join(tdir, "g_00400000")}
    t0 = time.time()
    CK.write_lightning_ckpt(paths["t2s"], load_params(os.path.join(root, "t2s.npz")), t2s_cfg, "t2s")
    CK.write_lightning_ckpt(paths["acoustic"], load_params(os.path.join(root, "acoustic.npz")), ac_cfg, "acoustic")
    CK.write_hifigan_ckpt(paths["vocoder"], load_params(os.path.join(root, "vocoder.npz")), voc_cfg)
    log(f"torch-format checkpoints written in {time.time() - t0:.1f} s: "
        + ", ".join(f"{os.path.basename(p)} {os.path.getsize(p) / 1e6:.1f} MB" for p in paths.values()))
    t0 = time.time()
    jobs = {kind: subprocess.Popen([sys.executable, "-m", "covomix_tpu_torch.convert_checkpoint",
                                    "hifigan" if kind == "vocoder" else "lightning", src,
                                    os.path.join(tdir, f"{kind}_converted.npz")],
                                   cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for kind, src in paths.items()}
    for kind, proc in jobs.items():
        out = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"convert_checkpoint of the {kind} file failed:\n{out[-3000:]}")
    log(f"convert_checkpoint x3 (in parallel): {time.time() - t0:.1f} s")
    for kind in paths:
        src = dict(named_leaves(load_params(os.path.join(root, f"{kind}.npz"))))
        got = dict(named_leaves(load_params(os.path.join(tdir, f"{kind}_converted.npz"))))
        if src.keys() != got.keys():
            raise AssertionError(f"converted {kind} tree has other leaves: {sorted(set(src) ^ set(got))[:8]}")
        if kind == "vocoder":
            rel = max(float((np.abs(got[k] - v) / np.maximum(np.abs(v), 1e-30)).max()) for k, v in src.items())
            ok = rel <= CKPT_WN_RTOL
            log(f"converted {kind}: {len(src)} leaves, folded weight norm max relative error {rel:.3e} "
                f"(tol {CKPT_WN_RTOL:g}) {'ok' if ok else 'FAIL'}")
        else:
            bad = [k for k, v in src.items() if not np.array_equal(got[k], v)]
            ok = not bad
            log(f"converted {kind}: {len(src)} leaves, bit-equal to the source tree: {ok} {bad[:5]}")
        if not ok:
            raise AssertionError(f"the converted {kind} checkpoint differs from its source tree")
    return paths


def run_serve_batch_from_torch(results, root, paths, batch=4, decode=512, text_len=64):
    """`covomix_tpu_torch.serve_batch.main([... --device cuda])` reading the
    `.ckpt` / `g_<step>` files directly, one batch at the serving shape (B=4,
    the two dialogue scripts repeated to fill it, 400-frame prompts, decode
    512, bf16): 256 flash launches and as many rotary pre-passes in the run,
    a finite [4, output_length(512)] wav, every saved wav 160 x its
    generated frames long."""
    import numpy as np
    import torch
    from scipy.io import wavfile
    from covomix_tpu_torch import serve_batch, serving
    from covomix_tpu_torch.models import vocoder as V

    out = os.path.join(root, "served")
    seen = []
    orig = serving.BatchedPipeline.__call__

    def call(self, *args, **kwargs):
        wav, res = orig(self, *args, **kwargs)
        seen.append((wav.detach().clone(), torch.minimum(res.lengths, res.lengths2).cpu().numpy()))
        return wav, res

    argv = ["--t2s_ckpt", paths["t2s"], "--acous_ckpt", paths["acoustic"], "--hifigan_ckpt", paths["vocoder"],
            "--text_dir", os.path.join(root, "texts"), "--prompt_dir", os.path.join(root, "prompts"),
            "--saved_dir", out, "--batch", str(batch), "--decode_len", str(decode), "--max_text_tokens",
            str(text_len), "--allow_fallback_vocab", "--device", "cuda"]
    serving.BatchedPipeline.__call__ = call
    zero_counts()
    try:
        t0 = time.time()
        serve_batch.main(argv)
        wall = time.time() - t0
    finally:
        serving.BatchedPipeline.__call__ = orig
    counts = flash_counts()
    log(f"serve_batch from .ckpt / g_ files: {wall:.2f} s incl. reading and converting them; launches {counts}")
    if len(seen) != 1 or counts != launches(fwd=256, rotary=256):
        raise AssertionError(f"expected one batch with 256 flash forwards and pre-passes, got {len(seen)} "
                             f"batches, {counts}")
    wav, lengths = seen[0]
    if tuple(wav.shape) != (batch, V.output_length(V.VocoderConfig(), decode)) or not bool(torch.isfinite(wav).all()):
        raise AssertionError(f"bad served wav: {tuple(wav.shape)}, finite {bool(torch.isfinite(wav).all())}")
    for i, name in enumerate(sorted(os.listdir(os.path.join(root, "texts")))):
        sr, w = wavfile.read(os.path.join(out, name.replace(".txt", ".wav")))
        if sr != 8000 or len(w) != max(int(lengths[i]) * 160, 160):
            raise AssertionError(f"served {name}: {sr} Hz, {len(w)} samples for {lengths[i]} frames")
    results.update(serve_torch_wall_s=wall, serve_torch_launches=counts)
    results["serve_multihost"] = run_serve_batch_multihost(root, argv, out)


def run_serve_batch_multihost(root, argv, plain_out):
    """Phase 20: the same serve_batch command with `--multihost` in a
    torchrun-style environment of one process (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE 1, RANK 0, LOCAL_RANK 0): a process group of one over NCCL,
    this process's share of the scripts (all of them) on its card; every wav
    bit for bit the run's without the flag, the group gone after."""
    import numpy as np
    import torch.distributed as dist
    from scipy.io import wavfile
    from covomix_tpu_torch import serve_batch
    from covomix_tpu_torch.parallel import multihost as MH

    out = os.path.join(root, "served_multihost")
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(MH.free_port()), "WORLD_SIZE": "1", "RANK": "0",
           "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    zero_counts()
    try:
        t0 = time.time()
        serve_batch.main([*argv[:argv.index("--saved_dir") + 1], out, *argv[argv.index("--saved_dir") + 2:],
                          "--multihost"])
        wall = time.time() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    counts = flash_counts()

    def same_wav(name):
        (sr_a, a), (sr_b, b) = (wavfile.read(os.path.join(d, name)) for d in (out, plain_out))
        return sr_a == sr_b and np.array_equal(a, b)

    names = sorted(os.listdir(plain_out))
    same = [name for name in names if os.path.exists(os.path.join(out, name)) and same_wav(name)]
    rec = {"wall_s": wall, "launches": counts, "wavs": len(names), "bit_equal": len(same),
           "group_left": dist.is_initialized()}
    log(f"20 serve_batch --multihost at world 1 over NCCL ({card_line()}): " + json.dumps(rec))
    if same != names or not names or counts != launches(fwd=256, rotary=256) or rec["group_left"]:
        raise AssertionError(f"serve_batch --multihost: {rec}; wavs equal to the plain run's: {same} of {names}")
    return rec


# ---------------------------------------------------------------------------
# phase 11: HiFi-GAN inference (copy synthesis with metrics) from the g_ file


HIFI_SECONDS = (3.0, 10.24, 20.0, 41.0)


def write_hifigan_wavs(wav_dir, seed=3):
    """8 kHz speech-like inputs of HIFI_SECONDS: harmonics of a gliding f0
    under a syllable-rate envelope, plus a little noise."""
    import numpy as np
    from covomix_tpu_torch.audio import save_wav

    os.makedirs(wav_dir)
    rs = np.random.RandomState(seed)
    for i, s in enumerate(HIFI_SECONDS):
        t = np.arange(int(8000 * s)) / 8000
        f0 = 110 + 40 * np.sin(2 * np.pi * 0.3 * t + rs.rand())
        phase = 2 * np.pi * np.cumsum(f0) / 8000
        x = sum(np.sin(h * phase) / h for h in range(1, 12)) * (0.55 + 0.45 * np.sin(2 * np.pi * 4 * t)) ** 2
        save_wav(os.path.join(wav_dir, f"f{i}.wav"), (0.25 * x + 0.005 * rs.randn(len(t))).astype(np.float32), 8000)


def generator_right_reach(cfg) -> float:
    """Mel frames to the left of the valid end that bucket padding can reach
    through the generator: conv_pre's 3 frames, each upsample's padding, each
    stage's widest ResBlock1 branch (sum of (k-1)/2 x dilation + (k-1)/2 per
    pair) at that stage's rate, conv_post's 3 samples. 19.45 for the covomix
    config."""
    reach, rate = 3.0, 1
    for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        reach += ((k - u) // 2) / (rate * u)
        rate *= u
        reach += max((kr - 1) // 2 * (sum(d) + len(d)) for kr, d in
                     zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)) / rate
    return reach + 3 / rate


def run_hifi_cli(argv):
    """`covomix_tpu_torch.hifigan_inference.main(argv)` in process, the
    launch counts set to 0 just before and read just after. Returns (one
    record per vocoded file: frames, vocode wall s, stage and tail
    launches, wav; the inputs the last file gave the fused stage / tail;
    the launch totals; the wall s)."""
    import torch
    from covomix_tpu_torch import hifigan_inference as HI
    from covomix_tpu_torch.ops import vocoder_tail as VT

    orig = (HI.vocode, VT.fused_stage, VT.fused_tail)
    calls, inputs = [], {}

    def vocode(params, cfg_, mel, fuse_tail):
        s0, n0 = VT.STAGE.launches, VT.TAIL.launches
        torch.cuda.synchronize()
        t0 = time.time()
        out = orig[0](params, cfg_, mel, fuse_tail)
        torch.cuda.synchronize()
        calls.append({"frames": mel.shape[1], "wall_s": time.time() - t0, "stage": VT.STAGE.launches - s0,
                      "tail": VT.TAIL.launches - n0, "wav": out[0].float().cpu().numpy()})
        return out

    def fused_stage(x, up_p, resblocks, kernels, dilations):
        inputs["stage"] = (x.contiguous().clone(), up_p, resblocks, None)
        return orig[1](x, up_p, resblocks, kernels, dilations)

    def fused_tail(x, up_p, resblocks, post_p, kernels, dilations):
        inputs["tail"] = (x.contiguous().clone(), up_p, resblocks, post_p)
        return orig[2](x, up_p, resblocks, post_p, kernels, dilations)

    HI.vocode, VT.fused_stage, VT.fused_tail = vocode, fused_stage, fused_tail
    zero_counts()
    try:
        t0 = time.time()
        HI.main(argv)
        wall = time.time() - t0
    finally:
        HI.vocode, VT.fused_stage, VT.fused_tail = orig
    return calls, inputs, {"stage": VT.STAGE.launches, "tail": VT.TAIL.launches, **flash_counts()}, wall


def run_hifigan_inference(results, root, g_path):
    """`covomix_tpu_torch.hifigan_inference.main([... --device cuda])` from the
    full-width `g_<step>` over the HIFI_SECONDS wavs, f32, with --metrics_csv,
    once with --fuse_tail and once without. Counts set to 0 before each run
    and read after: with --fuse_tail each file launches the f32 fused stage
    and tail once, without them neither; every wav finite and
    output_length(T) long; every CSV value finite; the two runs' wavs equal
    within HIFI_FUSED_TOL outside the generator's reach from the valid end
    (the fused kernels are static-length, the exact path masks padding).
    Then the f32 stage and tail timed on the inputs the longest file gave
    them."""
    import csv

    import numpy as np
    from covomix_tpu_torch.models import vocoder as V

    wav_dir = os.path.join(root, "hifi_wavs")
    write_hifigan_wavs(wav_dir)
    cfg = V.VocoderConfig()
    runs = {}
    for fuse in (True, False):
        csv_path = os.path.join(root, f"hifi_{'fused' if fuse else 'exact'}.csv")
        argv = ["--checkpoint_file", g_path, "--input_wavs_dir", wav_dir, "--output_dir",
                os.path.join(root, f"hifi_out_{fuse}"), "--metrics_csv", csv_path, "--device", "cuda"]
        calls, inputs, counts, wall = run_hifi_cli(argv + (["--fuse_tail"] if fuse else []))
        with open(csv_path) as f:
            rows = list(csv.DictReader(f))
        per_file = [(c["frames"], round(c["wall_s"], 6), c["stage"], c["tail"]) for c in calls]
        log(f"hifigan_inference {'--fuse_tail' if fuse else 'exact (valid_len)'} f32: {wall:.2f} s for "
            f"{len(calls)} files incl. metrics; per file (frames, vocode wall s, stage, tail launches) {per_file}; "
            f"launches {counts}; CSV {rows}")
        want = 1 if fuse else 0
        if len(calls) != len(HIFI_SECONDS) or any(c["stage"] != want or c["tail"] != want for c in calls):
            raise AssertionError(f"per file stage / tail launches {per_file}, expected {want} each")
        if counts != {"stage": want * len(calls), "tail": want * len(calls), **launches()}:
            raise AssertionError(f"launch totals {counts}")
        for c in calls:
            if len(c["wav"]) != V.output_length(cfg, c["frames"]) or not np.isfinite(c["wav"]).all():
                raise AssertionError(f"wav of {c['frames']} frames: {len(c['wav'])} samples, finite "
                                     f"{np.isfinite(c['wav']).all()}")
        if len(rows) != len(HIFI_SECONDS) or not all(np.isfinite(float(r[k])) for r in rows for k in r
                                                     if k != "file"):
            raise AssertionError(f"metrics CSV not complete and finite: {rows}")
        runs[fuse] = (calls, inputs, rows, counts)
    reach = int(np.ceil(generator_right_reach(cfg)))
    worst = 0.0
    for a, b in zip(runs[True][0], runs[False][0]):
        n = 160 * (a["frames"] - reach)
        diff = np.abs(a["wav"] - b["wav"])
        worst = max(worst, float(diff[:n].max()))
        log(f"  {a['frames']} frames: fused vs exact max |diff| {diff[:n].max():.3e} before the last {reach} "
            f"frames, {diff[n:].max():.3e} within them")
    log(f"hifigan_inference fused vs exact (f32, TF32 off): max |diff| {worst:.3e} outside the last {reach} frames "
        f"(the generator's reach, {generator_right_reach(cfg):.2f}) (tol {HIFI_FUSED_TOL:g}) "
        f"{'ok' if worst <= HIFI_FUSED_TOL else 'FAIL'}")
    if not worst <= HIFI_FUSED_TOL:
        raise AssertionError("the fused and exact hifigan_inference wavs differ")
    for fuse, (calls, _, rows, _) in runs.items():
        rtf = [c["wall_s"] / (len(c["wav"]) / 8000) for c in calls]
        results[f"hifi_{'fused' if fuse else 'exact'}"] = {
            "rtf_per_file": rtf, "audio_s": [len(c["wav"]) / 8000 for c in calls],
            "metrics_mean": {k: float(np.mean([float(r[k]) for r in rows])) for k in rows[0] if k != "file"}}
    results["hifi_launches"] = {kind: runs[True][3][kind] for kind in ("stage", "tail")}
    for kind, (x, up, blocks, post) in runs[True][1].items():   # the longest file's, f32
        time_vocoder(results, f"{kind}_f32", kind, x, up, blocks, post)


# ---------------------------------------------------------------------------
# phase 12: HuBERT semantic tokens through the extraction CLI


HUBERT_SECONDS = (3, 4, 5, 6, 8, 9.5, 20, 22, 30, 45, 50, 60)


def write_hubert_assets(root, seed=4):
    """Full-width random HuBERT weights (HubertConfig(), seeded, on the card)
    written as an `.npz` by the port's save_params, and 16 kHz wavs of
    HUBERT_SECONDS (harmonics under an envelope plus noise) in two
    subdirectories."""
    import numpy as np
    import torch
    from covomix_tpu_torch.audio import save_wav
    from covomix_tpu_torch.checkpoint.io import save_params
    from covomix_tpu_torch.models import hubert as H

    save_params(os.path.join(root, "hubert.npz"), H.init(torch.Generator(device="cuda").manual_seed(seed),
                                                         H.HubertConfig()), meta={"kind": "hubert", "config": {}})
    rs = np.random.RandomState(seed)
    for i, s in enumerate(HUBERT_SECONDS):
        t = np.arange(int(16000 * s)) / 16000
        x = sum(np.sin(2 * np.pi * h * (140 + 20 * i) * t) / h for h in range(1, 9))
        x = 0.2 * x * (0.5 + 0.5 * np.sin(2 * np.pi * 3.5 * t)) + 0.02 * rs.randn(len(t))
        sub = os.path.join(root, "wavs", f"spk{i % 2}")
        os.makedirs(sub, exist_ok=True)
        save_wav(os.path.join(sub, f"u{i}.wav"), x.astype(np.float32), 16000)


def run_extract_semantic_tokens(results, root, bf16: bool):
    """`covomix_tpu_torch.extract_semantic_tokens.main([... --device cuda])`
    at full width over the HUBERT_SECONDS wavs (f32, or bf16 with --bf16),
    counts set to 0 before and read after: each batch launches exactly 12
    non-causal forwards without lse (one per encoder layer) when its padded
    frame count is >= 512 and none below, no rotary pre-pass and no other
    flash kernel; every output a string array of num_output_frames ids in
    [0, 500). Returns the batches' (rows, padded frames, valid frames)."""
    import numpy as np
    import torch
    from covomix_tpu_torch import extract_semantic_tokens as EST
    from covomix_tpu_torch.audio import load_wav
    from covomix_tpu_torch.models import hubert as H

    cfg = H.HubertConfig()
    key = "bf16" if bf16 else "f32"
    out = os.path.join(root, f"codes_{key}")
    batches = []
    orig = H.wav2units_batch

    def wav2units_batch(params, cfg_, wav, padding_mask=None, valid_samples=None, dtype=torch.float32):
        c0 = flash_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        ids = orig(params, cfg_, wav, padding_mask=padding_mask, valid_samples=valid_samples, dtype=dtype)
        torch.cuda.synchronize()
        batches.append({"rows": wav.shape[0], "frames": padding_mask.shape[1], "wall_s": time.time() - t0,
                        "valid": padding_mask.sum(dim=1).tolist(),
                        "launches": {k: v - c0[k] for k, v in flash_counts().items()}})
        return ids

    argv = ["--data_dir", os.path.join(root, "wavs"), "--hubert_ckpt", os.path.join(root, "hubert.npz"),
            "--out_dir", out, "--device", "cuda"] + (["--bf16"] if bf16 else [])
    H.wav2units_batch = wav2units_batch
    zero_counts()
    try:
        t0 = time.time()
        EST.main(argv)
        wall = time.time() - t0
    finally:
        H.wav2units_batch = orig
    counts = flash_counts()
    log(f"extract_semantic_tokens {key}: {wall:.2f} s incl. reading the wavs; batches (rows, frames, s, flash "
        f"forwards) {[(b['rows'], b['frames'], round(b['wall_s'], 6), b['launches']['fwd']) for b in batches]}; "
        f"launches {counts}")
    for b in batches:
        want = cfg.encoder_layers if b["frames"] >= 512 else 0
        if b["launches"] != launches(fwd=want):
            raise AssertionError(f"a batch of {b['rows']} x {b['frames']} frames launched {b['launches']}, "
                                 f"expected {want} forwards and nothing else")
    if counts != launches(fwd=sum(cfg.encoder_layers for b in batches if b["frames"] >= 512)):
        raise AssertionError(f"launch totals {counts}")
    if not any(b["frames"] >= 512 for b in batches) or not any(b["frames"] < 512 for b in batches):
        raise AssertionError("the batches did not exercise both attention routes")
    frames = 0
    for i, s in enumerate(HUBERT_SECONDS):
        wav, _ = load_wav(os.path.join(root, "wavs", f"spk{i % 2}", f"u{i}.wav"), sr=16000)
        codes = np.load(os.path.join(out, f"spk{i % 2}", f"u{i}.hubert_code.npy"))
        ids = codes.astype(int)
        if codes.dtype.kind != "U" or len(ids) != H.num_output_frames(cfg, len(wav)) or not (
                (ids >= 0) & (ids < cfg.num_units)).all():
            raise AssertionError(f"u{i}: {codes.dtype}, {len(ids)} ids, range [{ids.min()}, {ids.max()}]")
        frames += len(ids)
    ext = sum(b["wall_s"] for b in batches)
    audio_s = sum(HUBERT_SECONDS)
    results[f"hubert_{key}"] = {"tokens": frames, "audio_s": audio_s, "batch_s": ext, "tokens_per_s": frames / ext,
                                "x_realtime": audio_s / ext, "cli_wall_s": wall, "launches": counts["fwd"],
                                "batches": [{k: v for k, v in b.items() if k != "launches"} for b in batches]}
    log(f"HuBERT {key}: {frames} tokens from {audio_s:.1f} s of audio in {ext:.4f} s of batches: "
        f"{frames / ext:.1f} tokens/s, {audio_s / ext:.1f}x realtime")
    return batches


def check_hubert_against_cpu(root):
    """One padded batch (11 s and 8 s, padded to 15 s: 749 frames, the flash
    route on the card) through the full-width HuBERT cut to 2 encoder layers,
    f32, TF32 off, on the card and on the CPU (layers.attend there): the
    features within HUBERT_FEAT_TOL; the share of equal k-means ids printed."""
    import dataclasses

    import numpy as np
    import torch
    from covomix_tpu_torch.checkpoint.io import load_params, params_from_numpy
    from covomix_tpu_torch.models import hubert as H

    cfg = dataclasses.replace(H.HubertConfig(), output_layer=2)
    tree = load_params(os.path.join(root, "hubert.npz"))
    lens = [11 * 16000, 8 * 16000]
    rs = np.random.RandomState(6)
    batch = np.zeros((2, 15 * 16000), np.float32)
    for i, n in enumerate(lens):
        batch[i, :n] = 0.1 * rs.randn(n)
    fv = [H.num_output_frames(cfg, n) for n in lens]
    outs = {}
    for dev in ("cuda", "cpu"):
        params = params_from_numpy(tree, dev)
        mask = torch.arange(H.num_output_frames(cfg, batch.shape[1]), device=dev)[None, :] < torch.tensor(
            fv, device=dev)[:, None]
        c0 = flash_counts()["fwd"]
        with torch.no_grad():
            feats = H.extract_features(params, cfg, torch.from_numpy(batch).to(dev), padding_mask=mask,
                                       valid_samples=torch.tensor(lens, device=dev),
                                       valid_frames=mask.sum(dim=1).to(torch.int32))
            ids = H.kmeans_assign(params, feats)
        outs[dev] = (feats.cpu(), ids.cpu(), flash_counts()["fwd"] - c0)
    (fc, ic, nc), (fh, ih, nh) = outs["cuda"], outs["cpu"]
    err = max(float((fc[i, :n] - fh[i, :n]).abs().max()) for i, n in enumerate(fv))
    agree = sum(int((ic[i, :n] == ih[i, :n]).sum()) for i, n in enumerate(fv)) / sum(fv)
    log(f"HuBERT (full width, 2 layers) card vs CPU, f32, batch [2, {batch.shape[1]}] ({mask.shape[1]} frames, "
        f"valid {fv}): features max_abs_err {err:.3e} (tol {HUBERT_FEAT_TOL:g}), |features| max "
        f"{float(fh.abs().max()):.3g}; k-means ids equal on {agree:.4%} of the valid frames; flash forwards card "
        f"{nc} / cpu {nh}")
    if nc != cfg.output_layer or nh != 0:
        raise AssertionError("the card run did not take the flash kernel in every layer, or the CPU run did")
    if not err <= HUBERT_FEAT_TOL:
        raise AssertionError(f"HuBERT features differ between the card and the CPU by {err}")
    return agree


def time_flash_hubert(results, key, dtype, b, t, valid, h=12, dh=64):
    """The forward at a HuBERT batch's shape [b, 12, t, 64] (no rotary, the
    batch's per-row valid frames) in `dtype`: the kernel's output on the
    timed inputs held against the plain version (F32_TOL / BF16_TOL), the
    kernel back to back and behind a sleep, the plain version, SDPA in the
    same dtype with the key mask, and the bound (operations over the peak
    of the dtype: f32 outside the tensor cores, bf16 on them)."""
    import torch
    import torch.nn.functional as F
    from covomix_tpu_torch.ops import flash_attention as FA

    q, k, v, valid_arr, _ = flash_inputs(b, h, t, dh, dtype, 97, valid, False)
    out = FA.KERNEL(q, k, v, valid_arr, None)
    ref = FA.flash_attention_plain(q, k, v, valid_arr, None)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    err = results[f"{key}_max_abs_err"] = (out.float() - ref.float()).abs().max().item()
    ok = bool(torch.isfinite(out).all()) and err <= tol
    log(f"flash check at the HuBERT batch's shape [{b},{h},{t},{dh}] {str(dtype)[6:]} valid={valid_arr.tolist()}: "
        f"max_abs_err {err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash kernel disagrees with its plain version at [{b},{h},{t},{dh}] {dtype}")
    del out, ref
    ms = both_times(results, key, lambda: FA.KERNEL(q, k, v, valid_arr, None), iters=10)
    results[f"{key}_plain_ms"] = cuda_time_ms(lambda: FA.flash_attention_plain(q, k, v, valid_arr, None),
                                              iters=3, warmup=1)
    mask = (torch.arange(t, device="cuda")[None, :] < valid_arr[:, None])[:, None, None, :]
    both_times(results, f"{key}_library", lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), iters=10)
    flops = 4.0 * h * dh * t * valid_arr.long().sum().item()
    nbytes = 4 * b * h * t * dh * q.element_size() + valid_arr.numel() * 4
    peak = H100_F32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    bf_ms, bb_ms = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    results[f"{key}_bound_ms"] = max(bf_ms, bb_ms)
    results[f"{key}_bound_by"] = "operations" if bf_ms >= bb_ms else "bytes"
    log(f"flash timing at the HuBERT batch's shape [{b},{h},{t},{dh}] {str(dtype)[6:]} (ms back to back / behind a "
        f"sleep): kernel {ms:.4f} / {results[f'{key}_device_ms']:.4f}; SDPA {results[f'{key}_library_ms']:.4f} / "
        f"{results[f'{key}_library_device_ms']:.4f}; plain {results[f'{key}_plain_ms']:.4f}; bound "
        f"{results[f'{key}_bound_ms']:.4f} ({results[f'{key}_bound_by']}: {flops / 1e9:.2f} GFLOP at "
        f"{peak / 1e12:g} TFLOP/s, {nbytes / 1e6:.1f} MB) -> {flops / results[f'{key}_device_ms'] / 1e9:.1f} "
        f"TFLOP/s on the card")


def run_hubert(results, root):
    """Phase 12: the HuBERT assets, the extraction CLI in f32 and in bf16,
    the card-vs-CPU check, and the forward timed at the largest flash
    batch's shape (most query-key pairs) in both dtypes."""
    t0 = time.time()
    write_hubert_assets(root)
    log(f"HuBERT assets (full-width .npz, {len(HUBERT_SECONDS)} wavs of {sum(HUBERT_SECONDS)} s) written in "
        f"{time.time() - t0:.1f} s")
    batches = run_extract_semantic_tokens(results, root, bf16=False)
    run_extract_semantic_tokens(results, root, bf16=True)
    results["hubert_ids_agree_cpu"] = check_hubert_against_cpu(root)
    import torch

    big = max((b for b in batches if b["frames"] >= 512), key=lambda b: b["rows"] * b["frames"] ** 2)
    for dtype, key in ((torch.float32, "hubert_fwd_f32"), (torch.bfloat16, "hubert_fwd_bf16")):
        time_flash_hubert(results, key, dtype, big["rows"], big["frames"], big["valid"])


# ---------------------------------------------------------------------------
# phase 13: speculative decode at full width


# draft-head fit steps (bench.py's BENCH_SPEC_FIT is 400): at 200 the fitted heads accept 0.988-0.994 of
# the drafts at gamma 2 / 4 / 8, 161 / 97 / 54 rounds for 481 tokens, far inside the gate's tokens / 2
# (PR 19 probe, NVIDIA H100 80GB HBM3, 700.00 W)
SPEC_FIT_STEPS = 200
SPEC_FIT_BATCH = 8
SPEC_FIT_EAGER = 8        # fit steps taken one at a time (gated step by step), then dispatches of SPEC_FIT_K steps
SPEC_FIT_K = 8            # (make_multi_step: one captured CUDA graph; the eager steps' host time ~10x the card's)
SPEC_TARGET = 576         # targets bucketed to 576: decoder T 578, on the causal flash kernels
SPEC_PATTERN = 480        # pattern tokens before the trained EOS
SPEC_GAMMAS = (2, 4, 8)
SPEC_DECODE = 512
# bf16 greedy [B, 1] steps and the verify's [B, gamma+1] forward may round
# their products differently: a first divergence passes only where greedy's
# top two logits lie within 2^-6 x max(1, |top logit|), a bf16 near-tie
SPEC_BF16_TIE = 2 ** -6


def spec_config():
    """The serving CoMix T2S with the draft heads after decoder layer 2 of 4
    (bench.py's spec_decode_stats config)."""
    import dataclasses

    return dataclasses.replace(full_width_configs()[0], target_early_exit_layer=2)


def spec_batch(rs, b):
    """bench.py's `synth` at the causal-kernel length: b texts of 24 ids in
    [1, 200) (the fallback vocab's characters lie there), targets the
    positional pattern (7 + j) % 501 for j < SPEC_PATTERN, then pad (-1, so
    the CE trains EOS right after the pattern), on both streams."""
    import numpy as np

    j = np.arange(SPEC_TARGET)
    tgt = np.where(j < SPEC_PATTERN, (7 + j) % 501, -1)
    return {"text_ids": rs.randint(1, 200, (b, 24)).astype(np.int32),
            "semantic_ids": np.ascontiguousarray(np.broadcast_to(np.stack([tgt, tgt], -1), (b, SPEC_TARGET, 2)))
            .astype(np.int32)}


def fit_draft_heads(results):
    """SPEC_FIT_STEPS optimizer steps with `t2s_loss_fn` (bf16, Adam 3e-4,
    EMA on) over fresh spec_batch rows: the first SPEC_FIT_EAGER one at a
    time (`train.loop.make_train_step`), each launching exactly 4 causal
    forwards with lse, 4 causal dQ and 4 causal dK/dV (the 4 decoder layers;
    the early-exit CE reuses the hidden states) and no other flash kernel,
    with a finite loss, the first step's gradient reaching both draft heads;
    the rest SPEC_FIT_K at a time (`make_multi_step`, one captured CUDA
    graph: the same batches in the same order, the same arithmetic), one
    capture whose warm-up launches one step's kernels and whose replays
    each run SPEC_FIT_K steps' (recorded at the capture), every loss finite.
    Returns (config, parameters)."""
    import numpy as np
    import torch
    from covomix_tpu_torch.data.datasets import stack_microbatches
    from covomix_tpu_torch.models import text2semantic as T
    from covomix_tpu_torch.train import loop
    from covomix_tpu_torch.util.misc import tree_map

    cfg = spec_config()
    tcfg = loop.TrainConfig(lr=3e-4)
    state = loop.init_train_state(T.init(torch.Generator(device="cuda").manual_seed(21), cfg), tcfg)
    loss_fn = loop.t2s_loss_fn(cfg, dtype=torch.bfloat16)
    step, multi = loop.make_train_step(loss_fn, tcfg), loop.make_multi_step(loss_fn, tcfg, SPEC_FIT_K)
    per_step = launches(fwd_lse_causal=4, bwd_dq_causal=4, bwd_dkv_causal=4)
    rs = np.random.RandomState(100)
    ms, dispatch_ms, losses = [], [], []
    zero_counts()
    for i in range(SPEC_FIT_EAGER):
        batch = spec_batch(rs, SPEC_FIT_BATCH)
        torch.cuda.synchronize()
        c0, t0 = flash_counts(), time.time()
        loss = float(step(state, batch, None)["loss"])      # waits for the card
        ms.append((time.time() - t0) * 1e3)
        losses.append(loss)
        made = {k: v - c0[k] for k, v in flash_counts().items()}
        if made != per_step or not np.isfinite(loss):
            raise AssertionError(f"draft-head fit step {i + 1}: loss {loss}, launches {made} (expected {per_step})")
        if i == 0:
            ee = state.params["early_exit"]
            heads = {h: float(ee[h]["w"].grad.abs().sum()) for h in ("to_logits", "to_logits2")}
            if not all(g > 0 for g in heads.values()):
                raise AssertionError(f"the first fit step's gradient does not reach the draft heads: {heads}")
    eager = flash_counts()
    for _ in range((SPEC_FIT_STEPS - SPEC_FIT_EAGER) // SPEC_FIT_K):
        batch = stack_microbatches([spec_batch(rs, SPEC_FIT_BATCH) for _ in range(SPEC_FIT_K)])
        torch.cuda.synchronize()
        t0 = time.time()
        dispatch = multi(state, batch, None)["loss"].tolist()       # waits for the card
        dispatch_ms.append((time.time() - t0) * 1e3 / SPEC_FIT_K)
        losses += dispatch
        if not np.all(np.isfinite(dispatch)):
            raise AssertionError(f"draft-head fit dispatch {len(dispatch_ms)}: losses {dispatch}")
    warm = {k: v - eager[k] for k, v in flash_counts().items()}
    recorded = {k: multi.last.launches.get(a, 0) for k, a in COUNTS.items()}
    replayed = {k: multi.replayed.get(a, 0) for k, a in COUNTS.items()}
    if (state.step != SPEC_FIT_STEPS or multi.captures != 1 or warm != per_step
            or recorded != {k: n * SPEC_FIT_K for k, n in per_step.items()}):
        raise AssertionError(f"draft-head fit: {state.step} steps, {multi.captures} captures, warm-up launches "
                             f"{warm}, {recorded} a dispatch (expected one capture, {per_step} a step)")
    median, dispatched = float(np.median(ms[2:])), float(np.median(dispatch_ms[1:]))
    # counted: the eager steps' and the warm-up's launches and the one capture's record; the replays run
    # that record each, which no counter sees, so they are reported apart (spec_fit_replays)
    totals = {k: v + recorded[k] for k, v in flash_counts().items()}
    log(f"draft-head fit (CoMix full width + early exit at layer 2, bf16, B={SPEC_FIT_BATCH}, decoder T "
        f"{SPEC_TARGET + 2}): {SPEC_FIT_STEPS} steps, {SPEC_FIT_EAGER} eager (median {median:.2f} ms a step) and "
        f"{len(dispatch_ms)} captured dispatches of {SPEC_FIT_K} (median {dispatched:.2f} ms a step, capture "
        f"{multi.last.capture_s:.2f} s), loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches counted {totals}, "
        f"{multi.replays} replays of the capture's record (by the record: {replayed})")
    results.update(spec_fit_step_ms=median, spec_fit_dispatch_ms_per_step=dispatched, spec_fit_loss=losses[-1],
                   spec_fit_launches=totals, spec_fit_replays={"replays": multi.replays,
                                                               "launches_per_replay": recorded})
    return cfg, tree_map(lambda p: p.detach(), state.params)


class GreedyLogits:
    """Records the scores `generate` samples from, per step and stream: the
    logits plus temperature x the Gumbel noise (greedy, temperature 1e-10:
    the logits). While it is entered, `sampling.gumbel_sample` is replaced
    by a copy that records (the same operations), and the decode runs its
    step directly (text2semantic.CAPTURE off): a captured graph would run
    the Python of the step only once. `streams`: samples per step."""

    def __init__(self, streams=2):
        self.steps, self.streams = [], streams

    def __enter__(self):
        import torch
        from covomix_tpu_torch.models import text2semantic as T
        from covomix_tpu_torch.ops import sampling as S

        self._orig, self._capture = S.gumbel_sample, T.CAPTURE

        def gumbel_sample(generator, logits, temperature=1.0, dim=-1):
            t = max(float(temperature), 1e-10)
            noise = S.gumbel_noise(generator, logits.shape, logits.device)
            self.steps.append((logits.detach().float() + t * noise).clone())
            return torch.argmax(logits / t + noise, dim=dim)

        S.gumbel_sample, T.CAPTURE = gumbel_sample, False
        return self

    def __exit__(self, *exc):
        from covomix_tpu_torch.models import text2semantic as T
        from covomix_tpu_torch.ops import sampling as S

        S.gumbel_sample, T.CAPTURE = self._orig, self._capture

    def margin(self, pos, stream, row, n_steps):
        """The top-two gap of the score sampled at step `pos` on `stream`,
        over max(1, |top score|). (The step function runs past the stop to
        the end of its chunk, so the record may hold more than n_steps
        steps; step `pos` is at pos * streams.)"""
        import torch

        top = torch.topk(self.steps[pos * self.streams + min(stream, self.streams - 1)][row], 2).values
        return float((top[0] - top[1]) / max(1.0, abs(float(top[0]))))


def hold_tokens(what, greedy, spec, logits=None):
    """The speculative tokens (both streams) against greedy's, row by row.
    Without `logits` (f32, TF32 off) every position must be equal. With the
    greedy run's GreedyLogits (bf16), a row may diverge where greedy's top
    two logits are within SPEC_BF16_TIE; a row whose first difference is
    pad against a token (the global stop moved) passes only beside such a
    tie. Returns [(row, position, relative margin)] of the divergences."""
    import numpy as np

    g = [greedy.tokens.cpu().numpy(), greedy.tokens2.cpu().numpy()]
    s = [spec.tokens.cpu().numpy(), spec.tokens2.cpu().numpy()]
    found, stops = [], []
    for r in range(g[0].shape[0]):
        diff = np.nonzero((g[0][r] != s[0][r]) | (g[1][r] != s[1][r]))[0]
        if not len(diff):
            continue
        p = int(diff[0])
        if any(min(g[k][r, p], s[k][r, p]) < 0 for k in (0, 1)) or logits is None:
            stops.append((r, p, float("inf")))
            continue
        found.append((r, p, max(logits.margin(p, k, r, greedy.num_steps) for k in (0, 1)
                                if g[k][r, p] != s[k][r, p])))
    ties = [d for d in found if d[2] < SPEC_BF16_TIE]
    log(f"{what}: tokens equal in {g[0].shape[0] - len(found) - len(stops)} of {g[0].shape[0]} rows; "
        f"divergences (row, position, top-two margin / max(1, |logit|)) {found + stops} (tie below "
        f"{SPEC_BF16_TIE:g})")
    if len(ties) != len(found) or (stops and not ties):
        raise AssertionError(f"{what}: speculative tokens differ from greedy's beyond a bf16 near-tie: "
                             f"{found + stops}")
    return found + stops


def spec_tokens(res):
    """Decoded positions per row (the shorter stream's, EOS included)."""
    import torch

    return torch.minimum(res.lengths, res.lengths2).double().cpu().numpy()


def run_spec_decode(results, cfg, params):
    """Greedy `generate` (temperature 1e-10, top_k_thres 1.0) against
    `generate_speculative` at every gamma of SPEC_GAMMAS on 8 seeded texts,
    max_length 512: in f32 with TF32 off the tokens must be equal position
    for position; in bf16 equal up to near-ties (hold_tokens). Every
    speculative run must take at most tokens / 2 verify rounds. Every
    decode is timed once, in turns (greedy's
    scores recorded by one more, untimed call of the direct step); bench.py's
    keys are logged for gamma 4."""
    import numpy as np
    import torch
    from covomix_tpu_torch.bench import spec_stats
    from covomix_tpu_torch.models import text2semantic as T

    text = torch.as_tensor(spec_batch(np.random.RandomState(7), 8)["text_ids"], device="cuda")
    gen = torch.Generator(device="cuda")
    table = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        runs = 1    # one timed run each (first calls included in f32); no gate reads the walls
        decoders = {"greedy": lambda: T.generate(params, cfg, gen.manual_seed(0), text, max_length=SPEC_DECODE,
                                                 temperature=1e-10, top_k_thres=1.0, dtype=dtype)}
        for g in SPEC_GAMMAS:
            decoders[g] = lambda g=g: T.generate_speculative(params, cfg, text, max_length=SPEC_DECODE, gamma=g,
                                                             dtype=dtype)
        logits, out, walls = GreedyLogits(), {}, {key: float("inf") for key in decoders}
        if dtype == torch.bfloat16:
            with logits:        # greedy's scores, recorded by the direct step, untimed
                decoders["greedy"]()
        # every decode once a turn, so that a slow spell of the shared host
        # falls on all of them alike
        for turn in range(runs):
            for key, fn in decoders.items():
                torch.cuda.synchronize()
                t0 = time.time()
                out[key] = fn()
                torch.cuda.synchronize()
                walls[key] = min(walls[key], time.time() - t0)
        greedy, wg = out["greedy"], walls["greedy"]
        gtok = spec_tokens(greedy)
        row = {"greedy_wall_s": wg, "greedy_steps": greedy.num_steps, "greedy_tokens": float(gtok.mean())}
        for gamma in SPEC_GAMMAS:
            spec, ws = out[gamma], walls[gamma]
            hold_tokens(f"spec decode {name} gamma {gamma} vs greedy", greedy, spec,
                        logits if dtype == torch.bfloat16 else None)
            stok = spec_tokens(spec)
            stats = spec_stats(gamma, greedy, wg, spec, ws)
            row[gamma] = {"wall_s": ws, "rounds": spec.num_steps, "tokens": float(stok.mean()),
                          "tokens_per_round": stats["t2s_spec_tokens_per_round"],
                          "acceptance": stats["t2s_spec_acceptance"], "speedup": stats["t2s_spec_speedup"]}
            if spec.num_steps > stok.mean() / 2:
                raise AssertionError(f"spec decode {name} gamma {gamma}: {spec.num_steps} rounds for "
                                     f"{stok.mean()} tokens (acceptance collapsed)")
        table[name] = row
        log(f"spec decode {name} (B=8, max_length {SPEC_DECODE}): " + json.dumps(row))
    bench_keys = spec_stats(4, out["greedy"], walls["greedy"], out[4], walls[4])   # the bf16 decodes
    log("spec decode bench keys (bf16): " + json.dumps(bench_keys))
    results.update(spec_decode=table, spec_bench=bench_keys)


def run_spec_serving(results, cfg, params, models, batch=4, prompt=400, decode=SPEC_DECODE):
    """BatchedPipeline(speculative=True, spec_gamma=4) at phase 4's shape
    (B=4, prompt 400, decode 512, bf16) with the fitted T2S and phase 4's
    VoMix and HiFi-GAN: one batch timed with the launch counts set to 0
    just before (256 flash forwards and as many pre-passes, nothing
    else), a finite wav of the expected shape, the tokens a greedy
    `generate` of the same rows gives (hold_tokens' bf16 rule), and the
    batch's split beside phase 4's."""
    import numpy as np
    import torch
    from covomix_tpu_torch.models import text2semantic as T, vocoder as V
    from covomix_tpu_torch.serving import BatchedPipeline

    _, ac_cfg, voc_cfg = full_width_configs()
    pipe = BatchedPipeline(params, cfg, models[0], ac_cfg, models[1], voc_cfg, decode_len=decode, cond_scale=0.7,
                           dtype=torch.bfloat16, device="cuda", speculative=True, spec_gamma=4)
    _, pt, pm = serving_inputs(batch, prompt, 24, ac_cfg.dim_in, 1)
    placed = pipe.place(spec_batch(np.random.RandomState(8), batch)["text_ids"], pt, pm)
    gen = torch.Generator(device="cuda").manual_seed(10)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.time()
    wav, res = pipe(gen, *placed)     # no warm-up: run_spec_decode and phase 4 ran every stage before
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = flash_counts()
    if counts != launches(fwd=256, rotary=256):
        raise AssertionError(f"speculative serving batch launched {counts}, expected 256 forwards and pre-passes")
    if tuple(wav.shape) != (batch, V.output_length(voc_cfg, decode)) or not bool(torch.isfinite(wav).all()):
        raise AssertionError(f"bad wav: shape {tuple(wav.shape)}, finite {bool(torch.isfinite(wav).all())}")
    with GreedyLogits() as logits:
        greedy = T.generate(pipe.t2s_params, cfg, gen, placed[0], max_length=decode, temperature=1e-10,
                            top_k_thres=1.0, dtype=torch.bfloat16)
    hold_tokens("speculative serving vs greedy", greedy, res, logits)

    stages, valid = split_serving_batch(pipe, gen, placed)
    audio_s = float(spec_tokens(res).sum()) * 0.02
    log(f"speculative serving B={batch} prompt={prompt} decode={decode} gamma 4 bf16: wall {wall:.4f} s for "
        f"{audio_s:.2f} s of generated audio (RTF {wall / audio_s:.5f}), verify rounds {res.num_steps}, tokens "
        f"{spec_tokens(res).tolist()}; split (s) {json.dumps(stages)}; phase 4 (sampling, EOS masked, 512 "
        f"frames each): {json.dumps(results['stages'])}")
    results.update(spec_serving_wall_s=wall, spec_serving_rtf=wall / audio_s, spec_serving_stages=stages,
                   spec_serving_launches=counts, spec_serving_rounds=res.num_steps)


def run_spec_dialogue(results, root, cfg, params):
    """The fitted T2S saved with save_params, then the dialogue CLI with
    --speculative on phase 6's prompts and scripts (run_generation_cli's gates:
    one fused stage and tail per vocode, 256 flash forwards and pre-passes
    per flow sample, int16 wavs of 160 x generated frames), and the decoded
    tokens against a greedy Synthesizer's (temperature 1e-10) decode of the
    same script."""
    import dataclasses

    import torch
    from covomix_tpu_torch import pipeline as P
    from covomix_tpu_torch.checkpoint.io import save_params

    save_params(os.path.join(root, "t2s_spec.npz"), params, meta={"config": dataclasses.asdict(cfg)})
    decodes = run_generation_cli(results, root, "dialogue", "covomix", t2s="t2s_spec.npz", extra=["--speculative"],
                                 key="spec_dialogue")
    results.pop("spec_dialogue_vocoder_inputs")
    spec_synth, spec = decodes[-1]
    greedy_synth = dataclasses.replace(spec_synth, speculative=False, temperature=1e-10)
    with GreedyLogits() as logits:
        greedy = greedy_synth._decode(P.clean_text(DIALOGUE_SCRIPT), torch.Generator(device="cuda").manual_seed(0))
    hold_tokens("speculative per-file decode vs a greedy Synthesizer", greedy, spec, logits)
    log(f"per-file dialogue RTF with --speculative {results['spec_dialogue_rtf']:.5f} (verify rounds "
        f"{results['spec_dialogue_steps']}), phase 6 (sampling) {results['dialogue_rtf']:.5f} "
        f"(decode steps {results['dialogue_steps']})")


def run_speculative(results, root, models):
    """Phase 13 (a-d), each part's wall logged; returns the fitted (config,
    parameters)."""
    walls = {}
    t0 = time.time()
    cfg, params = fit_draft_heads(results)
    walls["fit_s"] = time.time() - t0
    for name, fn in (("decode_s", lambda: run_spec_decode(results, cfg, params)),
                     ("serving_s", lambda: run_spec_serving(results, cfg, params, models)),
                     ("per_file_s", lambda: run_spec_dialogue(results, root, cfg, params))):
        t0 = time.time()
        fn()
        walls[name] = time.time() - t0
    log(f"phase 13 walls (s): {json.dumps(walls)}")
    results["spec_walls"] = walls
    return cfg, params


# ---------------------------------------------------------------------------
# phase 14: the one-program T2S decode, captured graphs against the direct step


# timed calls of each form, in turns (graph, direct, graph, ...); one keeps
# the whole script near half its time limit with phases 17-19 (the direct
# step's walls, the yardstick, are ~10x the graph's)
DECODE_TURNS = 1
# the per-file cell's 2048-step program is held and timed in both forms on its first PER_FILE_HELD
# steps (text2semantic.STOP_AFTER: the direct step ~2.6 s a call in place of ~21 s); the same captured
# program then runs the whole decode, timed and traced. The serving cells are held on all 512 steps
PER_FILE_HELD = 256
READ_METHODS = ("__bool__", "item", "__int__", "__float__", "__index__", "tolist", "numpy")


def traced_idle_share(what, fn, untraced_s=None, by_kernel=False):
    """fn() once under `profiling.trace`, inside a scope that ends after a
    synchronize; the scope's device idle share (1 - the union of the card's
    kernels, copies and sets over its wall), logged. Tracing slows the
    host's launches, so with `untraced_s`, the best wall of the same call
    untraced, the share of that wall the traced device work leaves idle is
    logged beside it. A trace that saw no device work fails. With
    `by_kernel`, returns (the share, the card's work by kernel)."""
    import torch
    from covomix_tpu_torch.util import profiling

    torch.cuda.synchronize()
    with profiling.trace() as prof:
        with profiling.scope("window"):
            fn()
            torch.cuda.synchronize()
    share = profiling.device_idle_share(prof, "window")
    if untraced_s is not None:
        share.update(untraced_wall_ms=untraced_s * 1e3,
                     idle_share_of_untraced_wall=max(0.0, 1.0 - share["busy_ms"] / (untraced_s * 1e3)))
    log(f"device idle share, {what}: {json.dumps(share)}")
    if share["device_events"] == 0:
        raise AssertionError(f"{what}: the trace shows no device activity")
    return (share, profiling.device_time_by_kernel(prof)) if by_kernel else share


@contextlib.contextmanager
def host_reads():
    """Yields a list that gets one name per tensor read back to the host
    (bool / item / int / float / index / tolist / numpy) while entered."""
    import torch

    orig = {name: getattr(torch.Tensor, name) for name in READ_METHODS}
    reads = []

    def counting(name):
        def read(self, *args, **kwargs):
            reads.append(name)
            return orig[name](self, *args, **kwargs)
        return read

    for name in READ_METHODS:
        setattr(torch.Tensor, name, counting(name))
    try:
        yield reads
    finally:
        for name, fn in orig.items():
            setattr(torch.Tensor, name, fn)


@contextlib.contextmanager
def decode_form(graph: bool):
    """The graph form (text2semantic.CAPTURE, the default) or the direct
    step on the card, the yardstick the graphs are held and timed against."""
    from covomix_tpu_torch.models import text2semantic as T

    prev, T.CAPTURE = T.CAPTURE, graph
    try:
        yield
    finally:
        T.CAPTURE = prev


@contextlib.contextmanager
def stop_after(steps):
    """Every decode cut after `steps` steps while entered
    (text2semantic.STOP_AFTER; None: not cut)."""
    from covomix_tpu_torch.models import text2semantic as T

    prev, T.STOP_AFTER = T.STOP_AFTER, steps
    try:
        yield
    finally:
        T.STOP_AFTER = prev


def decode_forms(what, fn, seed=None) -> dict:
    """fn(generator) -> GenerateResult, in both forms: the graph form's first
    call (capture included on a new shape), then DECODE_TURNS turns of
    graph, direct. Each call starts from a generator seeded `seed` (None:
    no generator) and is followed by one draw from it. Returns per form the
    last result, the walls, the host reads of the last call and the next
    draw."""
    import torch

    out = {}
    for turn in range(DECODE_TURNS + 1):
        for form in ("graph", "direct"):
            if turn == 0 and form == "direct":
                continue
            gen = None if seed is None else torch.Generator(device="cuda").manual_seed(seed)
            torch.cuda.synchronize()
            with decode_form(form == "graph"), host_reads() as reads:
                t0 = time.time()
                res = fn(gen)
                torch.cuda.synchronize()
                wall = time.time() - t0
            rec = out.setdefault(form, {"walls": []})
            if turn == 0:
                rec["first_call_s"] = wall
            else:
                rec["walls"].append(wall)
            rec.update(res=res, reads=len(reads),
                       next_draw=None if gen is None else torch.rand(8, generator=gen, device="cuda"))
    log(f"{what}: walls (s) graph {out['graph']['walls']} (first call {out['graph']['first_call_s']:.4f}), "
        f"direct {out['direct']['walls']}; steps {out['graph']['res'].num_steps} / "
        f"{out['direct']['res'].num_steps}; host reads per call {out['graph']['reads']} / {out['direct']['reads']}")
    return out


def hold_forms(what, forms, exact, redo=None, streams=2):
    """The graph form's result against the direct form's: num_steps equal,
    the generator's next draw equal, tokens equal (`exact`), or, in bf16,
    equal up to the near-tie rule of hold_tokens, the margins recorded by
    `redo()` (the direct form's decode again, under GreedyLogits of the
    decode's `streams`). Returns the divergences."""
    import torch

    g, d = forms["graph"], forms["direct"]
    if g["res"].num_steps != d["res"].num_steps:
        raise AssertionError(f"{what}: {g['res'].num_steps} steps captured, {d['res'].num_steps} direct")
    if g["next_draw"] is not None and not torch.equal(g["next_draw"], d["next_draw"]):
        raise AssertionError(f"{what}: the generator stands elsewhere after the captured decode")
    same = all(torch.equal(getattr(g["res"], f), getattr(d["res"], f)) for f in ("tokens", "tokens2"))
    if same:
        log(f"{what}: graph == direct (tokens, steps, next draw)")
        return []
    if exact or redo is None:
        raise AssertionError(f"{what}: the captured decode's tokens differ from the direct step's")
    with GreedyLogits(streams) as logits:
        ref = redo()
    return hold_tokens(f"{what}: graph vs direct", ref, g["res"], logits)


def per_step_ms(forms, steps) -> dict:
    return {form: {"best_s": min(rec["walls"]), "ms_per_step": min(rec["walls"]) / steps * 1e3,
                   "host_reads": rec["reads"], **({"first_call_s": rec["first_call_s"]} if "first_call_s" in rec
                                                   else {})}
            for form, rec in forms.items()}


def run_decode_graphs(results, serving_t2s, spec_cfg, spec_params):
    """Phase 14: `generate` and `generate_speculative` as CUDA graphs against
    the same step called directly, at full width with phase 4's T2S: the
    serving shape (B=4, 512 steps, min_length 512, sampled, bf16 and f32),
    the per-file shape (B=1, 2048 steps, sampled, bf16; both forms cut
    after PER_FILE_HELD steps, then the graph alone over the whole decode),
    and greedy / speculative at B=8 on phase 13's fitted heads (gamma 2 / 4 / 8, bf16).
    Tokens, steps and the generator's next draw must agree (f32 exactly,
    bf16 up to hold_tokens' near-tie); walls best of DECODE_TURNS in turns,
    ms per step or round, host reads per call, each graph's capture time,
    the peak memory, and the device idle share of each captured decode
    window."""
    import numpy as np
    import torch
    from covomix_tpu_torch.models import text2semantic as T

    cfg = full_width_configs()[0]
    torch.cuda.reset_peak_memory_stats()
    text_serving = torch.as_tensor(serving_inputs(4, 400, 64, 160, 1)[0], device="cuda")
    text_file = torch.as_tensor(np.random.RandomState(2).randint(1, 30000, (1, 48)), dtype=torch.int32,
                                device="cuda")
    cells = {"serving_bf16": (text_serving, 512, 512, torch.bfloat16, None),
             "serving_f32": (text_serving, 512, 512, torch.float32, None),
             "per_file_bf16": (text_file, 2048, 0, torch.bfloat16, PER_FILE_HELD)}
    table, idle = {}, {}
    for name, (text, max_length, min_length, dtype, held) in cells.items():
        def decode(gen, text=text, max_length=max_length, min_length=min_length, dtype=dtype):
            return T.generate(serving_t2s, cfg, gen, text, max_length=max_length, min_length=min_length,
                              dtype=dtype)

        what = f"decode {name}" + (f", first {held} of {max_length} steps" if held else "")
        with stop_after(held):
            forms = decode_forms(what, decode, seed=10)
            ties = hold_forms(what, forms, exact=dtype == torch.float32,
                              redo=lambda: decode(torch.Generator(device="cuda").manual_seed(10)))
        steps = forms["graph"]["res"].num_steps
        table[name] = {"steps": steps, "ties": ties, **per_step_ms(forms, steps)}
        graph_s = table[name]["graph"]["best_s"]
        if held:        # the same captured program over the whole decode
            torch.cuda.synchronize()
            t0 = time.time()
            res = decode(torch.Generator(device="cuda").manual_seed(10))
            torch.cuda.synchronize()
            graph_s = time.time() - t0
            table[name]["graph_full"] = {"steps": res.num_steps, "best_s": graph_s,
                                         "ms_per_step": graph_s / res.num_steps * 1e3}
        if name != "serving_f32":
            # per file the traced window is the timed prefix of the same captured program: a trace of all
            # 2048 steps (~1 M kernel events) took ~30 s to gather
            with stop_after(held):
                idle[f"{name}_graph"] = traced_idle_share(
                    f"decode {name}, graph" + (f", first {held} steps" if held else ""),
                    lambda: decode(torch.Generator(device="cuda").manual_seed(10)),
                    table[name]["graph"]["best_s"] if held else graph_s)

    text_spec = torch.as_tensor(spec_batch(np.random.RandomState(7), 8)["text_ids"], device="cuda")

    def greedy(gen):
        return T.generate(spec_params, spec_cfg, gen, text_spec, max_length=SPEC_DECODE, temperature=1e-10,
                          top_k_thres=1.0, dtype=torch.bfloat16)

    forms = {"greedy": decode_forms("greedy B=8 bf16", greedy, seed=0)}
    hold_forms("greedy B=8 bf16", forms["greedy"], exact=False,
               redo=lambda: greedy(torch.Generator(device="cuda").manual_seed(0)))
    for gamma in SPEC_GAMMAS:
        def spec(gen, gamma=gamma):
            return T.generate_speculative(spec_params, spec_cfg, text_spec, max_length=SPEC_DECODE, gamma=gamma,
                                          dtype=torch.bfloat16)

        forms[gamma] = decode_forms(f"speculative gamma {gamma} B=8 bf16", spec)
        hold_forms(f"speculative gamma {gamma} B=8 bf16", forms[gamma], exact=False,
                   redo=lambda: greedy(torch.Generator(device="cuda").manual_seed(0)))
    g = forms["greedy"]
    gsteps = g["graph"]["res"].num_steps
    tokens = float(spec_tokens(g["graph"]["res"]).mean())
    spec_row = {"greedy": {"steps": gsteps, "tokens": tokens, **per_step_ms(g, gsteps)}}
    for gamma in SPEC_GAMMAS:
        rounds = forms[gamma]["graph"]["res"].num_steps
        row = per_step_ms(forms[gamma], rounds)
        for form in ("graph", "direct"):
            row[form]["ms_per_round"] = row[form].pop("ms_per_step")
            row[form]["speedup_over_greedy"] = min(g[form]["walls"]) / row[form]["best_s"]
        spec_row[gamma] = {"rounds": rounds, **row}
    idle["greedy_b8_graph"] = traced_idle_share("greedy B=8 bf16, graph",
                                                lambda: greedy(torch.Generator(device="cuda").manual_seed(0)),
                                                spec_row["greedy"]["graph"]["best_s"])
    idle["spec_gamma4_graph"] = traced_idle_share(
        "speculative gamma 4, graph", lambda: T.generate_speculative(spec_params, spec_cfg, text_spec,
                                                                      max_length=SPEC_DECODE, gamma=4,
                                                                      dtype=torch.bfloat16),
        spec_row[4]["graph"]["best_s"])
    captures = [{"kind": key[0], "batch": key[2], "source": key[3][1], "dtype": str(key[5]), "max_length": key[6],
                 "gamma": key[7] if key[0] == "speculative" else None, "capture_s": dec.capture_s}
                for key, dec in T._GRAPHS.items()]
    memory = {"peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30, "graphs_cached": len(T._GRAPHS)}
    log(f"one-program decode (steps per read {T.STEPS_PER_READ}, rounds per read {T.ROUNDS_PER_READ}): "
        + json.dumps({"decode": table, "speculative": spec_row}))
    log("decode graphs captured: " + json.dumps(captures))
    log("decode memory: " + json.dumps(memory))
    results.update(decode_graphs=table, decode_spec=spec_row, decode_idle=idle, decode_captures=captures,
                   decode_memory=memory)


# ---------------------------------------------------------------------------
# phase 15: the port's serving benchmark (covomix_tpu_torch.bench)

# every key of the JAX bench's line at its default sweep 4,16,64, and of each
# batch_scaling row
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "chip", "chip_peak_bf16_tflops", "rtf_staged", "t2s_wall_s",
              "flow_wall_s", "vocoder_wall_s", "t2s_decoded_steps", "decode_len", "batch", "batch_scaling",
              "vocoder_samples_per_sec_per_chip", "hubert_tokens_per_sec_per_chip",
              "hubert_audio_s_per_sec_per_chip", "flow_model_tflops", "flow_mfu", "vocoder_mfu", "hubert_mfu",
              "vocoder_samples_per_sec_b64", "acoustic_train_ms_per_step", "acoustic_train_mfu",
              "acoustic_train_tflops_per_step", "t2s_train_ms_per_step", "t2s_train_mfu",
              "t2s_train_tflops_per_step", "t2s_spec_gamma", "t2s_spec_tokens_per_round", "t2s_spec_acceptance",
              "t2s_greedy_tok_per_s", "t2s_spec_tok_per_s", "t2s_spec_speedup", "rtf_b64")
BENCH_ROW_KEYS = ("rtf", "t2s_wall_s", "flow_wall_s", "vocoder_wall_s", "audio_s", "decoded_steps", "rtf_fused",
                  "fused_wall_s", "upload_s", "flow_mfu", "fused_mfu_lb")
BENCH_MFU_MAX = 1.05     # a share above this means the FLOP count is wrong, not the kernel
BENCH_DETAIL_B = (4,)     # the batches phase 15 looks into: fused stage / tail held and timed, flow traced
BENCH_CHECK_B = 64        # the bench's largest batch: there the fused stage / tail are held once, untimed
BENCH_FLASH_B = 64        # the bench's batch at whose flow shape phase 15 holds and times the flash forward
BENCH_RUNS = 1            # timed runs per B after the warm-up (the bench's default: 3 at B=4, 2 at the others)


def bench_part_launches(sweep) -> dict:
    """The kernel launches each call of a bench part must make: 256 forwards
    and 256 rotary pre-passes per flow sample (8 layers x 16 steps x 2
    evaluations), staged or in the one call, whose valid_len vocoder runs
    no fused kernel; one fused stage and tail per whole-mel generator call;
    8 lse forwards / dQ / dK-dV (and pre-passes) per VoMix step; 4 causal
    of each per T2S step (the encoder's 129 ids stay under 512); 12
    forwards per HuBERT batch; nothing in the decodes and the draft fit
    (under 512 positions)."""
    flow = {"fwd": 256, "rotary": 256}
    parts = {"hubert": {"fwd": 12}, "train_acoustic": {"fwd_lse": 8, "bwd_dq": 8, "bwd_dkv": 8, "rotary": 8},
             "train_t2s": {"fwd_lse_causal": 4, "bwd_dq_causal": 4, "bwd_dkv_causal": 4},
             "spec_fit": {}, "spec_greedy": {}, "spec_decode": {}}
    for b in sweep:
        parts.update({f"staged_t2s_b{b}": {}, f"staged_flow_b{b}": flow,
                      f"staged_vocoder_b{b}": {"stage": 1, "tail": 1}, f"serving_b{b}": flow})
    for b in (sweep[0], max(sweep)):
        parts[f"vocoder_b{b}"] = {"stage": 1, "tail": 1}
    return parts


def check_bench_line(line, sweep, decode):
    """Every JAX key, finite numbers, every MFU in (0, BENCH_MFU_MAX], the
    whole decode at every B in both paths, the card's facts, and each part's
    launches per call (bench_part_launches)."""
    missing = [k for k in BENCH_KEYS if k not in line]
    missing += [f"batch_scaling[{b}].{k}" for b in sweep for k in BENCH_ROW_KEYS + ("peak_mem_gib",)
                if k not in line["batch_scaling"][str(b)]]
    if missing:
        raise AssertionError(f"bench line lacks {missing}")

    def numbers(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from numbers(v, f"{path}.{k}")
        elif isinstance(node, (int, float)) and not isinstance(node, bool):
            yield path, node

    bad = [p for p, v in numbers(line, "line") if not math.isfinite(v)]
    mfus = {k: line[k] for k in ("flow_mfu", "vocoder_mfu", "hubert_mfu", "acoustic_train_mfu", "t2s_train_mfu")}
    for b in sweep:
        row = line["batch_scaling"][str(b)]
        mfus.update({f"b{b}.flow_mfu": row["flow_mfu"], f"b{b}.fused_mfu_lb": row["fused_mfu_lb"]})
        if row["decoded_steps"] != decode or row["fused_decoded_steps"] != decode:
            bad.append(f"B={b}: decoded {row['decoded_steps']} staged, {row['fused_decoded_steps']} in one call")
    bad += [f"{k}={v}" for k, v in mfus.items() if v is None or not 0 < v <= BENCH_MFU_MAX]
    if line["platform"] != "gpu" or line["device"]["power_limit"] is None or not 0 <= line["device_idle_share"] <= 1:
        bad.append(f"device facts {line['platform']} {line['device']} idle {line['device_idle_share']}")
    for part, per_call in bench_part_launches(sweep).items():
        rec = dict(line["launches"].get(part, {}))
        calls = rec.pop("calls", 0)
        if calls == 0 or rec != {k: n * calls for k, n in per_call.items()}:
            bad.append(f"{part}: {calls} calls made {rec}, expected {per_call} per call")
    if bad:
        raise AssertionError(f"bench line: {bad}")


def bench_vocoder_inputs(bench, b) -> dict:
    """{kind: (x, up, blocks, post)}: the fused stage's and tail's inputs in
    one generator call on the bench's staged mel of batch b."""
    import torch
    from covomix_tpu_torch.models import vocoder as V
    from covomix_tpu_torch.ops import vocoder_tail as VT

    inputs, orig = {}, (VT.fused_stage, VT.fused_tail)

    def fused_stage(x, up_p, resblocks, kernels, dilations):
        inputs["stage"] = (x.contiguous().clone(), up_p, resblocks, None)
        return orig[0](x, up_p, resblocks, kernels, dilations)

    def fused_tail(x, up_p, resblocks, post_p, kernels, dilations):
        inputs["tail"] = (x.contiguous().clone(), up_p, resblocks, post_p)
        return orig[1](x, up_p, resblocks, post_p, kernels, dilations)

    p = bench.pipe
    VT.fused_stage, VT.fused_tail = fused_stage, fused_tail
    try:
        V.generator(p.vocoder_params, p.vocoder_cfg, bench.mels[b], dtype=torch.bfloat16)
    finally:
        VT.fused_stage, VT.fused_tail = orig
    return inputs


def flow_device_breakdown(bench, b) -> dict:
    """One staged flow sample at batch b (the bench's models and inputs,
    bf16) under the profiler: the card's time by kernel, grouped
    into the flash forward and its pre-pass, the GEMMs (cuBLAS / CUTLASS
    kernels) and the rest (elementwise, norms, casts, copies), the top
    kernels, and the window's wall and busy time. Tracing slows the host's
    launches, so the window is not the untimed wall; the device sums are."""
    import torch
    from covomix_tpu_torch.models import acoustic as A
    from covomix_tpu_torch.util import profiling

    p = bench.pipe
    _, ph, cond = bench.staged_inputs(b)
    torch.cuda.synchronize()
    with profiling.trace() as prof:
        with profiling.scope("flow"):
            A.sample(p.acoustic_params, p.acoustic_cfg, bench.gen(11), ph, cond, cond_scale=p.cond_scale,
                     dtype=torch.bfloat16)
            torch.cuda.synchronize()
    kernels = profiling.device_time_by_kernel(prof)
    share = profiling.device_idle_share(prof, "flow")
    groups = {"flash": 0.0, "gemm": 0.0, "other": 0.0}
    for name, (_, ms) in kernels.items():
        low = name.lower()
        groups["flash" if "flash" in low else "gemm" if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma"))
               else "other"] += ms
    out = {"window_ms": share["window_ms"], "busy_ms": share["busy_ms"], "by_group_ms": groups,
           "top": [[name[:100], n, ms] for name, (n, ms) in list(kernels.items())[:12]]}
    log(f"flow sample B={b} on the card by kernel: " + json.dumps(out))
    return out


def run_bench(results):
    """Phase 15: `covomix_tpu_torch.bench` in this process with its defaults
    (full width, sweep 4, 16, 64, the JAX bench's loops and HuBERT sizes)
    but BENCH_RUNS timed runs at every B and phase 13's SPEC_FIT_STEPS
    draft fit (no gate reads either; fewer repetitions keep the script
    under 900 s); the bench itself raises on a non-finite or misshapen wav
    or id array and on a non-finite loss), its line printed and held by
    check_bench_line; then the fused stage and tail held to their plain
    versions (phase 3b's tolerances) and timed on the inputs one generator
    call on the bench's staged mel gives them at B = 4 (BENCH_DETAIL_B),
    and held once, untimed, at B = 64 (BENCH_CHECK_B: the tile follows the
    SM count, so the largest batch can tile otherwise); the card's time in
    one flow sample at B = 4 by kernel (flow_device_breakdown); the flash
    forward (with and without its pre-pass) held and timed at the flow's
    B=64 shape, [128, 16, 912, 64].
    The launch counts are set to 0 just before the bench and read just
    after."""
    import torch
    from covomix_tpu_torch import bench as BN

    t0 = time.time()
    settings = BN.Settings(runs=BENCH_RUNS, spec_fit=SPEC_FIT_STEPS)
    zero_counts()
    bench = BN.Bench(settings, "cuda")
    line = bench.run()
    totals = BN.launch_counts()
    log("bench line: " + json.dumps(line))
    check_bench_line(line, settings.sweep, settings.decode_len)
    results.update(bench_line=line, bench_launches=totals, bench_wall_s=time.time() - t0)
    for b in BENCH_DETAIL_B:
        for kind, (x, up, blocks, post) in bench_vocoder_inputs(bench, b).items():
            time_vocoder(results, f"{kind}_bench_b{b}", kind, x, up, blocks, post)
    for kind, (x, up, blocks, post) in bench_vocoder_inputs(bench, BENCH_CHECK_B).items():
        hold_vocoder(results, f"{kind}_bench_b{BENCH_CHECK_B}", kind, x, up, blocks, post,
                     f"the bench's B={BENCH_CHECK_B} inputs")
    results["bench_flow_breakdown"] = {b: flow_device_breakdown(bench, b) for b in BENCH_DETAIL_B}
    del bench
    torch.cuda.empty_cache()
    frames = BN.PROMPT + settings.decode_len      # the flow at B=64: 128 rows (CFG), every frame live
    time_flash(results, f"flash_bench_b{BENCH_FLASH_B}", 2 * BENCH_FLASH_B, frames, frames)
    log(f"phase 15 wall {time.time() - t0:.1f} s (the bench {results['bench_wall_s']:.1f} s)")


# ---------------------------------------------------------------------------
# phase 16: HiFi-GAN training at the covomix config's full width

# hifi-gan/config_covomix.json as SURVEY.md gives it (8 kHz, batch 80,
# segment 8032 = 160 x 50 + 32, initial channel 500)
GAN_CONFIG = {"resblock": "1", "batch_size": 80, "learning_rate": 0.0002, "adam_b1": 0.8, "adam_b2": 0.99,
              "lr_decay": 0.999, "seed": 1234, "upsample_rates": [5, 4, 4, 2], "upsample_kernel_sizes": [8, 8, 4, 4],
              "upsample_initial_channel": 500, "resblock_kernel_sizes": [3, 7, 11],
              "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]], "segment_size": 8032, "num_mels": 80,
              "num_freq": 241, "n_fft": 480, "hop_size": 160, "win_size": 480, "sampling_rate": 8000, "fmin": 0,
              "fmax": 4000, "fmax_for_loss": None, "num_workers": 4}
GAN_WAVS = 32                 # seeded 8 kHz training wavs of 2-12 s
GAN_F32_STEPS = 5             # 1 warm-up + 4 timed, the checkpoint at the last
GAN_BF16_STEPS = 3            # 1 warm-up + 2 timed
GAN_SPLIT_STEPS = 3           # D step / G step split: median of these after the runs
# card vs CPU, one f32 GAN step of a tiny generator at learning rate 0 (both
# G steps see the same discriminators): the five losses from cuDNN's and the
# CPU's convolutions, sums of up to 1024 x 41 f32 terms in another order
GAN_SMALL_LOSS_RTOL = 1e-4
# the log-mel on the card with TF32 allowed globally against the CPU's: the
# STFT and the projection pin full f32 inside mel_spectrogram, so only the
# summation order differs (TF32's 10-bit mantissa would show as ~1e-2)
MEL_TF32_TOL = 1e-4


def write_gan_assets(root, seed=6):
    """The config JSON, GAN_WAVS training wavs of 2-12 s, two held-out wavs
    and two wavs for the exported generator's vocode, speech-like as
    write_hifigan_wavs makes them."""
    import numpy as np
    from covomix_tpu_torch.audio import save_wav

    rs = np.random.RandomState(seed)
    sets = {"wavs": rs.uniform(2.0, 12.0, GAN_WAVS), "val": (3.0, 5.0), "vocode": (3.0, 10.24)}
    for d, secs in sets.items():
        os.makedirs(os.path.join(root, d))
        for i, s in enumerate(secs):
            t = np.arange(int(8000 * s)) / 8000
            f0 = 90 + 80 * rs.rand() + 40 * np.sin(2 * np.pi * 0.3 * t + rs.rand())
            phase = 2 * np.pi * np.cumsum(f0) / 8000
            x = sum(np.sin(h * phase) / h for h in range(1, 12)) * (0.55 + 0.45 * np.sin(2 * np.pi * 4 * t)) ** 2
            save_wav(os.path.join(root, d, f"u{i}.wav"), (0.25 * x + 0.005 * rs.randn(len(t))).astype(np.float32),
                     8000)
    with open(os.path.join(root, "config_covomix.json"), "w") as f:
        json.dump(GAN_CONFIG, f)


class TimedGanStep:
    """A GanStep whose every call is timed between synchronizes, its losses
    kept as floats."""

    def __init__(self, step):
        self.step, self.calls = step, []

    def __call__(self, state, batch):
        import torch

        torch.cuda.synchronize()
        t0 = time.time()
        metrics = self.step(state, batch)
        torch.cuda.synchronize()
        self.calls.append({"ms": (time.time() - t0) * 1e3, **{k: float(v) for k, v in metrics.items()}})
        return metrics


def run_gan_cli(root, ckpt, *extra):
    """`covomix_tpu_torch.hifigan_train.main` in process on the card, its
    steps timed. Returns (state, per-step records, stdout, peak GiB)."""
    import io

    import torch
    from covomix_tpu_torch import hifigan_train as HT

    made = []
    orig = HT.make_gan_step
    HT.make_gan_step = lambda *a, **k: made.append(TimedGanStep(orig(*a, **k))) or made[-1]
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    try:
        with contextlib.redirect_stdout(out):
            state = HT.main(["--input_wavs_dir", os.path.join(root, "wavs"), "--config",
                             os.path.join(root, "config_covomix.json"), "--checkpoint_path", ckpt,
                             "--stdout_interval", "1", "--num_workers", "4", "--device", "cuda", *extra])
    finally:
        HT.make_gan_step = orig
    return state, made[0].calls, out.getvalue(), torch.cuda.max_memory_allocated() / 2 ** 30


def gan_step_flops(device="cuda") -> dict:
    """FLOPs of one GAN step per sample at the covomix config's width, from
    torch.utils.flop_counter over the port's plain forwards on one segment:
    G (generator), D2 (MPD + MSD over the two signals). The D step is G +
    3 D2 (the forward, then weight and input gradients through the
    discriminators), the G step 3 G + 1.5 D2 (the forward and backward of
    the generator, the discriminators' forward and the input gradient of the
    generated half); the mels are left out (< 0.1 %)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from covomix_tpu_torch.models import vocoder as V

    g = torch.Generator(device=device).manual_seed(0)
    cfg = V.config_from_json(GAN_CONFIG)
    gen, mpd, msd = V.init_generator(g, cfg), V.init_mpd(g), V.init_msd(g)
    frames = GAN_CONFIG["segment_size"] // GAN_CONFIG["hop_size"]
    mel = torch.randn(1, frames, 80, generator=g, device=device)
    y = torch.randn(1, GAN_CONFIG["segment_size"], generator=g, device=device) * 0.1
    counts = {}
    with torch.no_grad():
        for name, fn in (("G", lambda: V.generator(gen, cfg, mel, fuse_tail=False)),
                         ("D2", lambda: (V.mpd(mpd, y, y), V.msd(msd, y, y)))):
            with FlopCounterMode(display=False) as fc:
                fn()
            counts[name] = fc.get_total_flops()
    counts["step"] = 4 * counts["G"] + 4.5 * counts["D2"]
    return counts


def check_gan_run(what, state, calls, steps):
    """Every step's five losses finite, the step count, MSD[0]'s spectral
    u / v of unit norm."""
    import torch

    if len(calls) != steps or not all(math.isfinite(c[k]) for c in calls for k in c):
        raise AssertionError(f"{what}: {len(calls)} steps (expected {steps}) or a non-finite loss: {calls}")
    d0 = state.msd_params["discriminators"][0]
    norms = [torch.linalg.vector_norm(leaf[k]).item() for leaf in [*d0["convs"], d0["conv_post"]] for k in "uv"]
    if not all(abs(n - 1.0) < 1e-4 for n in norms):
        raise AssertionError(f"{what}: spectral buffers not of unit norm: {norms}")


def gan_split(root, state, bf16=False):
    """The D step / G step split at full width (batch 80, segment 8032) on
    the trained state: the median of GAN_SPLIT_STEPS, each part ended by a
    synchronize; then one whole step traced for the device idle share."""
    import torch
    from covomix_tpu_torch import hifigan_train as HT
    from covomix_tpu_torch.audio import MelConfig
    from covomix_tpu_torch.data.prefetch import device_transfer
    from covomix_tpu_torch.models import vocoder as V
    from covomix_tpu_torch.train import gan as G

    h = GAN_CONFIG
    files = sorted(os.path.join(root, "wavs", f) for f in os.listdir(os.path.join(root, "wavs")))
    batch = device_transfer("cuda")(HT.make_sampler(h, files, None)(11))
    mel_cfg = MelConfig(8000, 480, 80, 160, 480, 0.0, 4000.0)
    step = G.make_gan_step(V.config_from_json(h), mel_cfg, mel_cfg, G.GanConfig(segment_size=h["segment_size"]),
                           dtype=torch.bfloat16 if bf16 else torch.float32)
    parts = {"inputs": [], "d_step": [], "g_step": []}
    for _ in range(GAN_SPLIT_STEPS):
        torch.cuda.synchronize()
        t0 = time.time()
        y, mel, target = step.inputs(batch)
        torch.cuda.synchronize()
        t1 = time.time()
        step.d_step(state, y, mel)
        torch.cuda.synchronize()
        t2 = time.time()
        step.g_step(state, y, mel, target)
        torch.cuda.synchronize()
        t3 = time.time()
        for part, a, b in zip(parts, (t0, t1, t2), (t1, t2, t3)):
            parts[part].append((b - a) * 1e3)
    split = {k: statistics.median(v) for k, v in parts.items()}
    idle = traced_idle_share(f"GAN step ({'bf16' if bf16 else 'f32'})", lambda: step(state, batch),
                             sum(split.values()) / 1e3)
    return split, idle


def check_gan_small_against_cpu():
    """One f32 GAN step of a tiny generator (initial channel 16, segment
    1600, B=2, learning rate 0) on the card and on the CPU from the same
    state and batch: the five losses within GAN_SMALL_LOSS_RTOL."""
    import numpy as np
    import torch
    from covomix_tpu_torch.audio import MelConfig
    from covomix_tpu_torch.checkpoint.io import params_from_numpy
    from covomix_tpu_torch.models import vocoder as V
    from covomix_tpu_torch.train import gan as G
    from covomix_tpu_torch.util.misc import tree_map

    voc = V.VocoderConfig(upsample_initial_channel=16)
    cfg = G.GanConfig(segment_size=1600, learning_rate=0.0)
    st = G.init_gan_state(torch.Generator().manual_seed(4), voc, cfg)
    trees = [tree_map(lambda t: t.detach().numpy().copy(), t) for t in (st.gen_params, st.mpd_params, st.msd_params)]
    y = (np.random.RandomState(5).randn(2, 1600) * 0.1).astype(np.float32)
    got = {}
    for dev in ("cuda", "cpu"):
        state = G.make_gan_state(*(params_from_numpy(t, dev) for t in trees), cfg)
        step = G.make_gan_step(voc, MelConfig(), MelConfig(), cfg)
        got[dev] = {k: float(v) for k, v in step(state, {"audio": torch.from_numpy(y).to(dev)}).items()}
    rel = {k: abs(got["cuda"][k] - got["cpu"][k]) / max(abs(got["cpu"][k]), 1e-30) for k in got["cpu"]}
    ok = all(r <= GAN_SMALL_LOSS_RTOL for r in rel.values())
    log(f"small f32 GAN step card vs CPU: {json.dumps(got)} relative {json.dumps(rel)} "
        f"(tol {GAN_SMALL_LOSS_RTOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the small GAN step's losses differ between the card and the CPU")
    return max(rel.values())


@contextlib.contextmanager
def tf32_allowed():
    """TF32 allowed for matmuls and cuDNN while entered, the flags put back
    after."""
    import torch

    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def check_mel_with_tf32_allowed():
    """The log-mel of a full batch (80 x 8032, seeded) on the card with TF32
    allowed globally, against the CPU's; the flags are put back after."""
    import numpy as np
    import torch
    from covomix_tpu_torch.audio import MelConfig, mel_spectrogram

    y = torch.from_numpy((np.random.RandomState(8).randn(80, 8032) * 0.1).astype(np.float32))
    with tf32_allowed():
        card = mel_spectrogram(y.cuda(), MelConfig()).cpu()
        still = torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    err = (card - mel_spectrogram(y, MelConfig())).abs().max().item()
    ok = err <= MEL_TF32_TOL and still
    log(f"log-mel on the card with TF32 allowed vs the CPU: max |diff| {err:.3e} (tol {MEL_TF32_TOL:g}), "
        f"global flags left allowed {still} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's log-mel is not full f32 under TF32-allowed flags")
    return err


def vocode_exported(results, root, g_path):
    """`hifigan_inference --fuse_tail --device cuda` from the exported
    generator over the two vocode wavs: exactly one f32 fused stage and one
    tail launch per file, each kernel held against its plain version on the
    inputs the last file gave it (phase 3b's f32 tolerance)."""
    import torch
    from covomix_tpu_torch.ops import vocoder_tail as VT

    calls, inputs, counts, _ = run_hifi_cli(["--checkpoint_file", g_path, "--input_wavs_dir",
                                             os.path.join(root, "vocode"), "--output_dir",
                                             os.path.join(root, "vocoded"), "--fuse_tail", "--device", "cuda"])
    per_file = [(c["frames"], c["stage"], c["tail"]) for c in calls]
    log(f"exported generator, hifigan_inference --fuse_tail: per file (frames, stage, tail) {per_file}; "
        f"launches {counts}")
    if len(calls) != 2 or any(c["stage"] != 1 or c["tail"] != 1 for c in calls) or counts != {
            "stage": 2, "tail": 2, **launches()}:
        raise AssertionError(f"exported generator: launches per file {per_file}, totals {counts}")
    errs = {}
    with torch.no_grad():
        for kind, (x, up, blocks, post) in inputs.items():
            packed = VT.pack_weights(up, blocks, post, (3, 7, 11), ((1, 3, 5),) * 3, x.dtype, x.device)
            plain = (VT.fused_tail_plain(x, up, blocks, post) if kind == "tail"
                     else VT.fused_stage_plain(x, up, blocks))
            errs[kind] = vocoder_agreement(f"exported generator's fused {kind}", x,
                                           (VT.TAIL if kind == "tail" else VT.STAGE)(x, packed), plain)
    results["gan_export_launches"] = {k: counts[k] for k in ("stage", "tail")}
    results["gan_export_max_abs_err"] = errs


def run_gan_training(results, root):
    """Phase 16: `covomix_tpu_torch.hifigan_train.main` at the covomix
    config's full width (batch 80, segment 8032, initial channel 500) on
    seeded synthetic 8 kHz wavs: f32 for GAN_F32_STEPS steps with the
    checkpoint and one validation at the last, `--resume`d for one step,
    `--bf16` for GAN_BF16_STEPS; the gates (finite losses, unit-norm
    spectral buffers, the resumed counters, the tiny card-vs-CPU step, the
    log-mel under TF32-allowed flags); the median ms per step, the D / G
    split, peak GiB, audio seconds trained per second and a traced step's
    idle share; then the exported generator through `hifigan_inference
    --fuse_tail`."""
    import torch
    from covomix_tpu_torch.train import gan as G

    t_start = time.time()
    write_gan_assets(root)
    audio_s = GAN_CONFIG["batch_size"] * GAN_CONFIG["segment_size"] / GAN_CONFIG["sampling_rate"]
    flops = gan_step_flops()
    step_tflop = flops["step"] * GAN_CONFIG["batch_size"] / 1e12
    gan = {"card": card_line(), "audio_s_per_step": audio_s, "flops_per_sample": flops, "tflop_per_step": step_tflop,
           "mel_tf32_max_abs_err": check_mel_with_tf32_allowed()}
    ckpt = os.path.join(root, "cp_f32")
    val = ["--input_validation_dir", os.path.join(root, "val"), "--validation_interval", str(GAN_F32_STEPS)]
    for dtype, steps, extra in (("f32", GAN_F32_STEPS, ["--checkpoint_interval", str(GAN_F32_STEPS), *val]),
                                ("bf16", GAN_BF16_STEPS, ["--checkpoint_interval", "1000000", "--bf16"])):
        t0 = time.time()
        path = ckpt if dtype == "f32" else os.path.join(root, "cp_bf16")
        state, calls, out, peak = run_gan_cli(root, path, "--training_steps", str(steps), *extra)
        check_gan_run(f"GAN {dtype}", state, calls, steps)
        med = statistics.median(c["ms"] for c in calls[1:])
        split, idle = gan_split(root, state, bf16=dtype == "bf16")
        gan[dtype] = {"ms_per_step_median": med, "ms_per_step": [c["ms"] for c in calls], "split_ms": split,
                      "peak_gib": peak, "audio_s_per_s": audio_s / (med / 1e3), "idle": idle,
                      "tflop_per_s": step_tflop / (med / 1e3),
                      "losses_last": {k: v for k, v in calls[-1].items() if k != "ms"}, "wall_s": time.time() - t0}
        log(f"GAN {dtype} at full width (batch {GAN_CONFIG['batch_size']} x {GAN_CONFIG['segment_size']}, "
            f"{gan['card']}): {steps} steps, ms per step "
            f"{[round(c['ms'], 2) for c in calls]}, median of the timed {med:.2f} ms, {audio_s / (med / 1e3):.1f} "
            f"audio s per s, split {json.dumps(split)}, peak {peak:.2f} GiB; stdout {out.strip().splitlines()[-2:]}")
        del state
        torch.cuda.empty_cache()
    if not os.path.isfile(os.path.join(ckpt, f"g_{GAN_F32_STEPS:08d}.npz")):
        raise AssertionError("the f32 run wrote no g_ checkpoint")
    state, calls, out, _ = run_gan_cli(root, ckpt, "--training_steps", str(GAN_F32_STEPS + 1), "--checkpoint_interval",
                                       str(GAN_F32_STEPS))
    check_gan_run("GAN resumed", state, calls, 1)
    counts = (state.step, G.opt_count(state.opt_g), G.opt_count(state.opt_d))
    if f"resumed from step {GAN_F32_STEPS}" not in out or counts != (GAN_F32_STEPS + 1,) * 3:
        raise AssertionError(f"the resumed run's counters {counts} do not continue from {GAN_F32_STEPS}")
    gan["resumed_counters"] = counts
    del state
    torch.cuda.empty_cache()
    gan["small_card_vs_cpu_max_rel"] = check_gan_small_against_cpu()
    vocode_exported(results, root, os.path.join(ckpt, f"g_{GAN_F32_STEPS:08d}.npz"))
    gan["wall_s"] = time.time() - t_start
    results["gan"] = gan
    log(f"phase 16 wall {gan['wall_s']:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: data-parallel training at full width

DP_WORLD1_STEPS = 4
DP_STEPS = 2
DP_CELLS = (("vomix", "bf16"), ("vomix", "f32"), ("t2s", "bf16"), ("t2s", "f32"))
DP_GAN_STEPS = 2
# dp=2 against one process on the same global batch with the same draws. A
# rank runs its GEMMs and convolutions at half the rows, where cuBLAS and
# cuDNN may pick other kernels (sums in another order), and the all-reduce
# adds the two halves: the loss and the grad norm within DP_RTOL relative
# (f32: rounding of ~1e-7 an op; bf16: a rounding of an activation to bf16
# may flip and carry through the layers). After the steps every parameter
# within DP_BOUND lr of the steps: an Adam update moves an element by at
# most 1.0055 lr at these counts (|m_hat| / sqrt(v_hat) by Cauchy-Schwarz,
# for the betas of Adam and of the GAN's AdamW), so two runs differ by at
# most twice that a step, when a near-zero gradient changes sign; and in
# f32 all but DP_TIGHT_SHARE of the elements within DP_TIGHT lr (in bf16
# the share is logged).
DP_RTOL = {"f32": 1e-4, "bf16": 2e-2}
DP_TIGHT, DP_TIGHT_SHARE = 1e-2, 1e-3
DP_BOUND = 2 * 1.0055
# Phases 17-20 train the VoMix and CoMix T2S recipes at every width of the recipes but a cut depth: their
# gates hold a rank's arithmetic against one process on the same model, which does not depend on the
# depth, while their collectives, staged through the host by gloo, carry every parameter (VoMix 250.5 M at
# depth 8, 68.0 M at 2; CoMix T2S 76.8 M at 4 + 4 layers, 46.3 M at 2 + 2). VoMix: layers (pp=2 needs an
# even count); T2S: (source, target) layers, the target layers on the causal kernels
PAR_DEPTH = {"vomix": 2, "t2s": (2, 2)}
PAR_DEPTH_FLAGS = {"vomix": ["--CoVoMix_depth", str(PAR_DEPTH["vomix"])],
                   "t2s": ["--text2semantic_source_depth", str(PAR_DEPTH["t2s"][0]),
                           "--text2semantic_target_depth", str(PAR_DEPTH["t2s"][1])]}
_PV, _PT = PAR_DEPTH["vomix"], PAR_DEPTH["t2s"][1]
DP_PER_STEP = {"vomix": {"bf16": launches(fwd_lse=_PV, bwd_dq=_PV, bwd_dkv=_PV, rotary=_PV),
                         "f32": launches(fwd_lse=_PV, bwd_dq=_PV, bwd_dkv=_PV)},
               "t2s": {dt: launches(fwd_lse_causal=_PT, bwd_dq_causal=_PT, bwd_dkv_causal=_PT)
                       for dt in ("bf16", "f32")}}


def dp_args(root, cell, dtype, *extra):
    """The train CLI's flags of the VoMix or CoMix T2S recipe at full width
    and PAR_DEPTH's depth, in bf16 or f32, on phase 17's items (and `extra`
    flags)."""
    from covomix_tpu_torch.train import cli

    recipe = [a for a in (VOMIX_RECIPE if cell == "vomix" else COMIX_T2S_RECIPE) if a != "--bf16"]
    return cli.build_argparser().parse_args(["--base_dir", os.path.join(root, cell), *recipe, *PAR_DEPTH_FLAGS[cell],
                                             "--device", "cuda", "--seed", "0",
                                             *(["--bf16"] if dtype == "bf16" else []), *extra])


def flat_params(tree):
    import torch
    from covomix_tpu_torch.util.misc import tree_leaves

    return torch.cat([p.detach().reshape(-1) for p in tree_leaves(tree)])


def timed_step(step, *args):
    """One step between synchronizes, the launch counts set to 0 just before
    it and read just after, with the gradient collectives it made, its tp
    collectives (count, bytes, host ms), FSDP's parameter gathers and the
    pp / sp ppermutes (count, bytes, host ms)."""
    import torch
    from covomix_tpu_torch.parallel import collectives as C, tensor as TPX, train_step as TS

    zero_counts()
    before = (TS.GRAD_SYNCS, TS.GRAD_SYNC_BYTES, TPX.COLLECTIVES, TPX.BYTES, TPX.SECONDS, TS.PARAM_GATHERS,
              C.PPERMUTES, C.PPERMUTE_BYTES, C.PPERMUTE_SECONDS)
    torch.cuda.synchronize()
    t0 = time.time()
    metrics = step(*args)
    metrics = {k: float(v) for k, v in metrics.items()}      # waits for the card
    torch.cuda.synchronize()
    return {"ms": (time.time() - t0) * 1e3, **metrics, "launches": flash_counts(), "syncs": TS.GRAD_SYNCS - before[0],
            "sync_bytes": TS.GRAD_SYNC_BYTES - before[1], "tp_collectives": TPX.COLLECTIVES - before[2],
            "tp_bytes": TPX.BYTES - before[3], "tp_ms": (TPX.SECONDS - before[4]) * 1e3,
            "param_gathers": TS.PARAM_GATHERS - before[5], "ppermutes": C.PPERMUTES - before[6],
            "ppermute_bytes": C.PPERMUTE_BYTES - before[7], "ppermute_ms": (C.PPERMUTE_SECONDS - before[8]) * 1e3}


def dp_train_cell(args, steps, mesh=None, fsdp=False):
    """`steps` optimizer steps of the recipe `args` with the train CLI's
    model, loss, loader and draws: in one process on the global batch
    (mesh None) or as a rank of `mesh` on its rows and its parts of the
    state (its tp shards; with `fsdp` its dp shards too). Returns (a record
    per step, the state, the learning rates of the steps, the parts'
    specs)."""
    import torch
    from covomix_tpu_torch.data.datasets import data_loader
    from covomix_tpu_torch.parallel import train_step as TS
    from covomix_tpu_torch.train import cli, loop

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    _, params, loss_fn = cli.build_model(args, gen, mesh)
    dataset, _ = cli._datasets(args)
    loader = data_loader(dataset, args.batch_size, cli.build_collate(args)[0], seed=args.seed)
    tcfg = cli.train_config(args, max(1, len(dataset) // args.batch_size))
    specs = None
    if mesh is None:
        state, step = loop.init_train_state(params, tcfg), loop.make_train_step(loss_fn, tcfg)
    else:
        state, specs = TS.init_sharded_state(params, tcfg, mesh, tp=mesh.tp > 1, fsdp=fsdp)
        step = TS.make_sharded_train_step(loss_fn, tcfg, mesh, specs)
    recs = []
    for _ in range(steps):
        batch = next(loader)
        if mesh is not None:
            batch = TS.shard_batch(mesh, batch)
        recs.append({**timed_step(step, state, batch, gen), "rows": len(next(iter(batch.values())))})
    return recs, state, [loop.reference_lr_schedule(tcfg)(i) for i in range(steps)], specs


def dp_gan(root, steps, mesh=None):
    """`steps` GAN steps at the covomix config's full width with
    hifigan_train's state, configs and sampler (batch 80, f32): in one
    process, or as a rank of `mesh` on its rows of each batch."""
    import glob

    import torch
    from covomix_tpu_torch import hifigan_train as HT
    from covomix_tpu_torch.data.prefetch import device_transfer
    from covomix_tpu_torch.parallel import train_step as TS
    from covomix_tpu_torch.train import gan as G

    cfg_path = os.path.join(root, "gan", "config_covomix.json")
    args = HT.build_parser().parse_args(["--input_wavs_dir", os.path.join(root, "gan", "wavs"), "--config", cfg_path,
                                         "--device", "cuda"])
    files = sorted(glob.glob(os.path.join(args.input_wavs_dir, "*.wav")))
    voc_cfg, mel_cfg, mel_loss_cfg, gan_cfg = HT.configs(GAN_CONFIG, len(files))
    state = HT.initial_state(args, GAN_CONFIG, voc_cfg, gan_cfg, "cuda")
    if mesh is not None:
        TS.replicate_state(mesh, state)
    step = G.make_gan_step(voc_cfg, mel_cfg, mel_loss_cfg, gan_cfg, mesh=mesh)
    sample, to_device = HT.make_sampler(GAN_CONFIG, files, None), device_transfer("cuda")
    recs = []
    for i in range(steps):
        batch = sample(args.seed + i)
        if mesh is not None:
            batch = TS.shard_batch(mesh, batch)
        recs.append({**timed_step(step, state, to_device(batch)), "rows": len(batch["audio"])})
    return recs, state, [G.learning_rate(gan_cfg, i) for i in range(steps)]


def time_all_reduce(numel, iters=3) -> float:
    """ms of one SUM all-reduce of `numel` f32 on the card in the current
    process group, between synchronizes (and barriers), the median of
    `iters` after one warm-up."""
    import torch
    import torch.distributed as dist

    flat = torch.zeros(numel, device="cuda")
    times = []
    for _ in range(iters + 1):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.time()
        dist.all_reduce(flat)
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    return statistics.median(times[1:])


def param_agreement(flat, ref, lrs, dtype) -> dict:
    """max |flat - ref|, its bound (DP_BOUND lr a step) and the share beyond DP_TIGHT lr."""
    err = (flat - ref).abs()
    lr = max(lrs)
    return {"max_abs_err": float(err.max()), "bound": DP_BOUND * sum(lrs),
            "tight_share": float((err > DP_TIGHT * lr).float().mean()), "numel": flat.numel(), "dtype": dtype}


def dp_rank(root, ref_dir, out_dir):
    """One of two ranks on the one card over gloo (phase 17b / c): gloo's
    all_reduce and broadcast on device tensors checked first; then each
    DP_CELLS recipe and the GAN step on its rows; the parameters held
    against the one-process run's (saved in ref_dir) and bit for bit
    against rank 0's; the step records, the all-reduce's ms and each
    cell's peak GiB into out_dir/rank<r>.json."""
    import torch
    import torch.distributed as dist
    from covomix_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False      # as the reference process runs
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(2, "cuda")
    forms = check_collectives(mesh)
    out = {"rank": mesh.rank, "device": str(mesh.device), "backend": dist.get_backend(), "forms": forms}
    cells = [(cell, dt) for cell, dt in DP_CELLS] + [("gan", "f32")]
    for cell, dt in cells:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        if cell == "gan":
            recs, state, lrs = dp_gan(root, DP_GAN_STEPS, mesh)
            tensors = [state.gen_params, state.mpd_params, state.msd_params]
        else:
            recs, state, lrs, _ = dp_train_cell(dp_args(root, cell, dt), DP_STEPS, mesh)
            tensors = state.params
        wall = time.time() - t0
        flat = flat_params(tensors)
        rank0 = flat.clone()
        dist.broadcast(rank0, src=0)
        ref = torch.load(os.path.join(ref_dir, f"{cell}_{dt}.pt")).to("cuda")
        out[f"{cell}_{dt}"] = {"steps": recs, "lrs": lrs, "wall_s": wall,
                               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                               "params_equal_rank0": bool(torch.equal(rank0, flat)),
                               "params": param_agreement(flat, ref, lrs, dt),
                               "all_reduce_ms": time_all_reduce(flat.numel(), iters=1)}
        del state, flat, rank0, ref, tensors
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)


def write_dp_items(root):
    """Phase 17's data: 24 VoMix and 24 CoMix T2S items (phases 8 / 9's
    generators and seeds) and the GAN config with its 32 wavs."""
    write_vomix_items(os.path.join(root, "vomix"), 24, 0)
    write_t2s_items(os.path.join(root, "t2s"), 24, 0)
    os.makedirs(os.path.join(root, "gan"))
    write_gan_assets(os.path.join(root, "gan"))


def run_dp_world1(results, root):
    """Phase 17a: the VoMix recipe (bf16, B=8, T=832) through the train CLI
    for DP_WORLD1_STEPS steps in a process group of one over NCCL
    (`--coordinator_address`), then the same steps without a group: the
    logged losses and grad norms and the final state (parameters, EMA,
    Adam moments, counters) bit for bit equal, one gradient all-reduce a
    step in the group and none without, the flash launches of phase 8 in
    both. Then one NCCL all-reduce of the gradient bucket timed alone."""
    import numpy as np
    from covomix_tpu_torch.parallel import multihost as MH, train_step as TS

    logs = os.path.join(root, "logs")
    argv = ["--base_dir", os.path.join(root, "vomix"), *VOMIX_RECIPE, *PAR_DEPTH_FLAGS["vomix"], "--device", "cuda",
            "--log_every", "1",
            "--num_eval_files", "0", "--ckpt_every", "1000", "--no_wandb", "--log_dir", logs, "--seed", "0"]
    runs = {}
    for name, extra in (("nccl_world1", ["--coordinator_address", f"127.0.0.1:{MH.free_port()}",
                                         "--num_processes", "1", "--process_id", "0"]), ("no_group", [])):
        syncs = TS.GRAD_SYNCS
        steps, _, totals, peak, first_s, _ = run_train_cli(argv + ["--run_name", name, *extra], "evaluate_acoustic",
                                                           DP_WORLD1_STEPS, resume=False)
        check_steps(f"17a {name}", steps, DP_PER_STEP["vomix"]["bf16"])
        with np.load(os.path.join(logs, name, "checkpoints", f"step_{DP_WORLD1_STEPS:08d}", "state.npz")) as z:
            state = {k: z[k] for k in z.files}
        runs[name] = {"steps": steps, "totals": totals, "syncs": TS.GRAD_SYNCS - syncs, "state": state,
                      "peak_gib": peak, "run_s": first_s,
                      "ms_per_step_median": statistics.median(s["ms"] for s in steps[1:])}
    group, plain = runs["nccl_world1"], runs["no_group"]
    if [(s["loss"], s["grad_norm"]) for s in group["steps"]] != [(s["loss"], s["grad_norm"]) for s in plain["steps"]]:
        raise AssertionError("17a: the world-1 group's losses / grad norms differ from the run without a group")
    if group["state"].keys() != plain["state"].keys() or any(
            not np.array_equal(group["state"][k], plain["state"][k]) for k in plain["state"]):
        raise AssertionError("17a: the world-1 group's final state differs from the run without a group")
    if group["syncs"] != DP_WORLD1_STEPS or plain["syncs"] != 0:
        raise AssertionError(f"17a: gradient all-reduces {group['syncs']} / {plain['syncs']}, expected "
                             f"{DP_WORLD1_STEPS} / 0")
    numel = sum(v.size for k, v in plain["state"].items() if k.startswith("params/"))
    MH.initialize(f"127.0.0.1:{MH.free_port()}", 1, 0, device="cuda")
    try:
        ar_ms = time_all_reduce(numel + 1, iters=10)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    results["dp_world1_launches"] = group["totals"]
    a = {name: {k: r[k] for k in ("syncs", "peak_gib", "run_s", "ms_per_step_median")} | {
        "ms_per_step": [round(s["ms"], 3) for s in r["steps"]]} for name, r in runs.items()}
    a.update(grad_bucket_numel=numel + 1, grad_bucket_bytes=4 * (numel + 1), nccl_world1_all_reduce_ms=ar_ms,
             losses=[s["loss"] for s in plain["steps"]], state_arrays_equal=len(plain["state"]))
    a["depth"] = PAR_DEPTH["vomix"]
    log(f"17a world 1 over NCCL vs no group (VoMix bf16 B=8, depth {PAR_DEPTH['vomix']}, {card_line()}): "
        + json.dumps(a))
    return a


def run_dp_training(results, root):
    """Phase 17: data-parallel training at full width. (a) run_dp_world1;
    (b) each DP_CELLS recipe (global B 8 VoMix, 6 CoMix T2S, at bf16 and
    f32) and (c) the GAN step (batch 80, f32) for DP_STEPS / DP_GAN_STEPS
    steps in this process on the global batch, their parameters saved, then
    two ranks on this card over gloo (dp_rank) on the same batches and
    draws; held here: every rank's losses and grad norms within DP_RTOL of
    the one-process run's, its parameters within the bounds, the two
    ranks' bit for bit, one gradient all-reduce a VoMix / T2S step and two
    a GAN step, the flash launches of a rank's step those of a one-process
    step (the kernels run at the rank's rows). The kernel libraries are
    built before the ranks start."""
    import torch
    from covomix_tpu_torch.parallel import multihost as MH

    from covomix_tpu_torch.ops import flash_attention as FA

    t_start = time.time()
    FA.KERNEL.build(64)           # here, once: the ranks load the library this process built
    write_dp_items(root)
    dp = {"card": card_line(), "world1": run_dp_world1(results, root)}
    ref_dir, out_dir = os.path.join(root, "ref"), os.path.join(root, "ranks")
    os.makedirs(ref_dir)
    os.makedirs(out_dir)
    refs = {}
    for cell, dt in [*DP_CELLS, ("gan", "f32")]:
        if cell == "gan":
            recs, state, lrs = dp_gan(root, DP_GAN_STEPS)
            tensors = [state.gen_params, state.mpd_params, state.msd_params]
        else:
            recs, state, lrs, _ = dp_train_cell(dp_args(root, cell, dt), DP_STEPS)
            tensors = state.params
        save_reference(ref_dir, f"{cell}_{dt}", flat_params(tensors), recs, lrs)
        refs[f"{cell}_{dt}"] = recs
        del state, tensors
        torch.cuda.empty_cache()
    t0 = time.time()
    MH.spawn(dp_rank, 2, root, ref_dir, out_dir, device="cuda", backend="gloo")
    spawn_s = time.time() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    cells = {}
    for key, ref in refs.items():
        cell, dt = key.split("_")
        per_step = DP_PER_STEP[cell][dt] if cell != "gan" else launches()
        syncs = 2 if cell == "gan" else 1
        for rank in ranks:
            got = rank[key]
            what = f"17 dp=2 {key} rank {rank['rank']}"
            for i, (s, r) in enumerate(zip(got["steps"], ref)):
                for k in ("loss", "grad_norm") if cell != "gan" else ("loss_disc", "loss_gen", "mel_error", "loss_fm",
                                                                      "loss_adv"):
                    if not abs(s[k] - r[k]) <= DP_RTOL[dt] * abs(r[k]):
                        raise AssertionError(f"{what} step {i + 1}: {k} {s[k]} vs one process {r[k]}")
                if s["launches"] != per_step or s["syncs"] != syncs or s["rows"] * 2 != r["rows"]:
                    raise AssertionError(f"{what} step {i + 1}: launches {s['launches']} (expected {per_step}), "
                                         f"{s['syncs']} all-reduces, {s['rows']} rows of {r['rows']}")
            if ref[0]["launches"] != per_step:
                raise AssertionError(f"17 one-process {key}: launches {ref[0]['launches']}")
            p = got["params"]
            if not got["params_equal_rank0"] or not p["max_abs_err"] <= p["bound"] or (
                    dt == "f32" and not p["tight_share"] <= DP_TIGHT_SHARE):
                raise AssertionError(f"{what}: parameters {p}, equal to rank 0's: {got['params_equal_rank0']}")
        r0 = ranks[0][key]
        cells[key] = {"one_process_ms": [round(s["ms"], 3) for s in ref],
                      "dp2_ms": [[round(s["ms"], 3) for s in rank[key]["steps"]] for rank in ranks],
                      "all_reduce_ms": [rank[key]["all_reduce_ms"] for rank in ranks],
                      "all_reduce_bytes_per_step": r0["steps"][0]["sync_bytes"],
                      "peak_gib": [rank[key]["peak_gib"] for rank in ranks], "params": r0["params"],
                      "loss_rel_err": max(abs(s["loss" if cell != "gan" else "loss_gen"] -
                                              r["loss" if cell != "gan" else "loss_gen"]) /
                                          abs(r["loss" if cell != "gan" else "loss_gen"])
                                          for rank in ranks for s, r in zip(rank[key]["steps"], ref)),
                      "launches_per_step": r0["steps"][0]["launches"], "rows_per_rank": r0["steps"][0]["rows"],
                      "depth": PAR_DEPTH.get(cell)}
        log(f"17 dp=2 {key} ({dp['card']}): " + json.dumps(cells[key]))
    dp.update(dp2=cells, spawn_s=spawn_s, wall_s=time.time() - t_start, depth=PAR_DEPTH,
              backend=ranks[0]["backend"], devices=[r["device"] for r in ranks])
    results["dp"] = dp
    results["dp2_launches"] = {key: c["launches_per_step"] for key, c in cells.items()}
    log(f"phase 17 wall {dp['wall_s']:.1f} s at depth {json.dumps(PAR_DEPTH)} (the two ranks {spawn_s:.1f} s)")


def save_reference(ref_dir, key, flat, recs, lrs):
    """A one-process run's final parameters (flat, on the CPU) and its step
    records and learning rates, for the ranks to be held against."""
    import torch

    torch.save(flat.cpu(), os.path.join(ref_dir, f"{key}.pt"))
    with open(os.path.join(ref_dir, f"{key}.json"), "w") as f:
        json.dump({"recs": recs, "lrs": lrs}, f)


def check_collectives(mesh) -> dict:
    """The collectives of phases 17 and 18 on device tensors, each held to
    its arithmetic before any cell runs: all_reduce and broadcast over the
    world; over each axis of more than one rank, all_gather and
    reduce_scatter (parallel/mesh.py); over tp, copy_to_tp / reduce_from_tp
    / gather_from_tp forward and backward in f32 and bf16
    (parallel/tensor.py). Returns the form each axis took (chosen by its
    group's backend name)."""
    import torch
    import torch.distributed as dist
    from covomix_tpu_torch.parallel import mesh as M, tensor as TPX

    world, rank = dist.get_world_size(), dist.get_rank()
    t = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(t)
    b = torch.full((4,), float(rank + 7), device="cuda")
    dist.broadcast(b, src=0)
    if not (bool((t == world * (world + 1) / 2).all()) and bool((b == 7).all())):
        raise AssertionError(f"collectives on device tensors: all_reduce {t.tolist()}, broadcast {b.tolist()}")
    forms = {"world": dist.get_backend()}
    base = torch.arange(6.0, device="cuda").reshape(2, 3)
    for axis in ("dp", "tp"):
        group, n, index = mesh.axis_info(axis)
        if n == 1:
            continue
        peers = ([d * mesh.n + mesh.rank % mesh.n for d in range(n)] if axis == "dp"
                 else [mesh.dp_rank * mesh.n + k for k in range(n)])
        got = M.all_gather(base + 100 * rank, 1, group, n, index)
        scattered = M.reduce_scatter((base + 100 * rank).repeat(n, 1), 0, group, n, index)
        if not (torch.equal(got, torch.cat([base + 100 * p for p in peers], dim=1))
                and torch.equal(scattered, sum(base + 100 * p for p in peers))):
            raise AssertionError(f"{axis} all_gather / reduce_scatter on device tensors: {got.tolist()}, "
                                 f"{scattered.tolist()}")
        forms[axis] = (f"{M.backend(group)}: all_gather_into_tensor / reduce_scatter_tensor"
                       if M.backend(group) == "nccl" else f"{M.backend(group)}: all_reduce (-0.0 fill / own block)")
    if mesh.tp > 1:
        r, total = mesh.tp_rank + 1.0, mesh.tp * (mesh.tp + 1) / 2
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.full((2, 3), r, dtype=dtype, device="cuda", requires_grad=True)
            y = TPX.copy_to_tp(mesh, x)
            (y * r).sum().backward()
            ok = bool((y == r).all()) and bool((x.grad == total).all())
            x = torch.full((2, 3), r, dtype=dtype, device="cuda", requires_grad=True)
            y = TPX.reduce_from_tp(mesh, x)
            (y * r).sum().backward()
            ok &= bool((y == total).all()) and bool((x.grad == r).all())
            x = torch.full((2, 3), r, dtype=dtype, device="cuda", requires_grad=True)
            y = TPX.gather_from_tp(mesh, x, dim=1)
            weight = torch.arange(3 * mesh.tp, dtype=dtype, device="cuda")
            (y * weight).sum().backward()
            ok &= torch.equal(y, torch.arange(1, mesh.tp + 1, dtype=dtype, device="cuda").repeat_interleave(3)
                              .expand(2, -1)) and torch.equal(x.grad, weight[3 * mesh.tp_rank: 3 * mesh.tp_rank + 3]
                                                              .expand(2, -1))
            if not ok:
                raise AssertionError(f"tp collectives ({dtype}) on device tensors disagree with their arithmetic")
    return forms


# phase 18: tensor-parallel and FSDP training at full width

# (cell, dtype, dp, tp, fsdp) of phase 18's cells, DP_STEPS steps each: (a) tp=2 for both recipes in
# both precisions, (b) dp=2 with FSDP and (c) dp=2 x tp=2 with FSDP on the bf16 VoMix cell
TP_CELLS = {"tp2_vomix_bf16": ("vomix", "bf16", 1, 2, False), "tp2_vomix_f32": ("vomix", "f32", 1, 2, False),
            "tp2_t2s_bf16": ("t2s", "bf16", 1, 2, False), "tp2_t2s_f32": ("t2s", "f32", 1, 2, False),
            "dp2_fsdp_vomix_bf16": ("vomix", "bf16", 2, 1, True),
            "dp2_tp2_fsdp_vomix_bf16": ("vomix", "bf16", 2, 2, True)}
# the tp collectives of one step (forward + backward) over tp=2 at full width: VoMix, its layers x
# (attention, FFN) x (copy_to_tp, reduce_from_tp), and the time MLP's gather and copy; CoMix T2S,
# its source layers x (the attention's copy and reduce, the gathered w1 and bias of the FFN's 1365
# pairs, which 2 does not divide), its target layers x (self-attention 2, cross-attention's context,
# query and null-KV copies and its reduce 4, FFN 2), sem_emb's lookup gather and the two logit
# heads' copy and gather (at depth 8 and 4 + 4: 34 and 53)
TP_COLLECTIVES = {"vomix": PAR_DEPTH["vomix"] * 2 * 2 + 2,
                  "t2s": PAR_DEPTH["t2s"][0] * (2 + 2) + PAR_DEPTH["t2s"][1] * (2 + 4 + 2) + 1 + 2 * 2}


def replicas_equal(mesh, state, specs) -> dict:
    """Per axis of more than one rank: whether the parameters and EMA of the
    leaves not split over it are bit-equal to its first rank's (one
    broadcast within the axis group); None when every leaf is split over it."""
    import torch
    import torch.distributed as dist
    from covomix_tpu_torch.util.misc import named_leaves

    out = {}
    for axis in (mesh.axis, "dp"):
        group, n, _ = mesh.axis_info(axis)
        src = mesh.rank % mesh.n if axis == "dp" else mesh.dp_rank * mesh.n     # the axis' first rank
        if n == 1:
            continue
        held = [t.detach().reshape(-1) for tree in (state.params, state.ema_params)
                for path, t in named_leaves(tree) if axis not in specs[path]]
        if not held:
            out[axis] = None
            continue
        mine = torch.cat(held)
        first = mine.clone()
        dist.broadcast(first, src=src, group=group)
        out[axis] = {"equal": bool(torch.equal(first, mine)), "numel": mine.numel()}
    return out


def resident_bytes(state) -> dict:
    """Bytes of a rank's parameters, Adam moments and EMA."""
    from covomix_tpu_torch.util.misc import tree_leaves

    size = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    moments = [st[k] for st in state.optimizer.state.values() for k in ("exp_avg", "exp_avg_sq") if k in st]
    return {"params": size(tree_leaves(state.params)), "adam": size(moments), "ema": size(tree_leaves(state.ema_params))}


def tp_cells(root, ref_dir, names, out):
    """Phase 18's cells `names` as one rank on the one card over gloo, into
    `out`: for each mesh they use, the collectives checked on device tensors
    (check_collectives); then each cell on the rank's rows and parts, its
    gathered parameters held against the one-process run's (saved in
    ref_dir), its replicated parts against the first rank of each axis; the
    step records, the resident bytes and peak GiB."""
    import torch
    from covomix_tpu_torch.parallel.mesh import gather_params, make_mesh

    meshes = {}
    for name in names:
        cell, dt, dp, tp, fsdp = TP_CELLS[name]
        if (dp, tp) not in meshes:    # every rank builds the meshes (and their groups) in the same order
            meshes[dp, tp] = make_mesh(dp, "cuda", tp=tp)
            out["forms"][f"{dp}x{tp}"] = check_collectives(meshes[dp, tp])
        mesh = meshes[dp, tp]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        recs, state, lrs, specs = dp_train_cell(dp_args(root, cell, dt), DP_STEPS, mesh, fsdp)
        wall = time.time() - t0
        flat = flat_params(gather_params(mesh, state.params, specs))
        ref = torch.load(os.path.join(ref_dir, f"{cell}_{dt}.pt")).to("cuda")
        out[name] = {"steps": recs, "lrs": lrs, "wall_s": wall, "dp_rank": mesh.dp_rank, "tp_rank": mesh.tp_rank,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "replicas": replicas_equal(mesh, state, specs), "params": param_agreement(flat, ref, lrs, dt),
                     "resident_bytes": resident_bytes(state)}
        del state, flat, ref
        torch.cuda.empty_cache()


def check_tp_cell(name, ranks, ref):
    """Phase 18's gates on every rank's record of one cell (module
    docstring, 18)."""
    cell, dt, dp, tp, fsdp = TP_CELLS[name]
    per_step = DP_PER_STEP[cell][dt]
    want = {"tp_collectives": TP_COLLECTIVES[cell] if tp > 1 else 0, "syncs": 3 if fsdp else 1,
            "param_gathers": 1 if fsdp else 0}
    for rank in ranks:
        got = rank[name]
        what = f"18 {name} rank {rank['rank']}"
        for i, (s, r) in enumerate(zip(got["steps"], ref["recs"])):
            for k in ("loss", "grad_norm"):
                if not abs(s[k] - r[k]) <= DP_RTOL[dt] * abs(r[k]):
                    raise AssertionError(f"{what} step {i + 1}: {k} {s[k]} vs one process {r[k]}")
            counts = {k: s[k] for k in want}
            if s["launches"] != per_step or counts != want or s["rows"] * dp != r["rows"]:
                raise AssertionError(f"{what} step {i + 1}: launches {s['launches']} (expected {per_step}), "
                                     f"collectives {counts} (expected {want}), {s['rows']} rows of {r['rows']}")
        p = got["params"]
        if not p["max_abs_err"] <= p["bound"] or (dt == "f32" and not p["tight_share"] <= DP_TIGHT_SHARE):
            raise AssertionError(f"{what}: parameters {p}")
        if not all(v is None or v["equal"] for v in got["replicas"].values()) or (
                tp > 1 and got["replicas"]["tp"] is None):
            raise AssertionError(f"{what}: replicated parts {got['replicas']}")


def check_tp(results, spawns, refs, names):
    """Phase 18's records of every rank held by check_tp_cell, logged and
    kept in results["tp"]."""
    tp = {"card": card_line(), "forms": {k: v for sp in spawns.values() for k, v in sp["ranks"][0]["forms"].items()
                                         if "x" in k and k.split("x")[1].isdigit()}, "cells": {}}
    for name in names:
        cell, dt, dp, tpn, fsdp = TP_CELLS[name]
        ranks = spawns[dp * tpn]["ranks"]
        check_tp_cell(name, ranks, refs[f"{cell}_{dt}"])
        ref = refs[f"{cell}_{dt}"]["recs"]
        tp["cells"][name] = {
            "one_process_ms": [round(s["ms"], 3) for s in ref],
            "ms": [[round(s["ms"], 3) for s in rank[name]["steps"]] for rank in ranks],
            "tp_collectives_per_step": ranks[0][name]["steps"][0]["tp_collectives"],
            "tp_bytes_per_step": ranks[0][name]["steps"][0]["tp_bytes"],
            "tp_ms": [[round(s["tp_ms"], 3) for s in rank[name]["steps"]] for rank in ranks],
            "grad_sync_bytes_per_step": ranks[0][name]["steps"][0]["sync_bytes"],
            "resident_bytes": [rank[name]["resident_bytes"] for rank in ranks],
            "peak_gib": [round(rank[name]["peak_gib"], 3) for rank in ranks],
            "wall_s": [round(rank[name]["wall_s"], 3) for rank in ranks],
            "params": ranks[0][name]["params"], "replicas": [rank[name]["replicas"] for rank in ranks],
            "loss_rel_err": max(abs(s["loss"] - r["loss"]) / abs(r["loss"])
                                for rank in ranks for s, r in zip(rank[name]["steps"], ref)),
            "launches_per_step": ranks[0][name]["steps"][0]["launches"],
            "rows_per_rank": ranks[0][name]["steps"][0]["rows"], "depth": PAR_DEPTH[cell]}
        log(f"18 {name} ({tp['card']}): " + json.dumps(tp["cells"][name]))
    results["tp"] = tp
    results["tp_launches"] = {name: c["launches_per_step"] for name, c in tp["cells"].items()}
    log(f"phase 18 collective forms {json.dumps(tp['forms'])}")


# ---------------------------------------------------------------------------
# phase 19: pipeline- and sequence-parallel training at full width

PP_MICROBATCHES = 4
# (dtype, dp, axis, size) of phase 19's cells, DP_STEPS steps each of the VoMix recipe (global B 8, T 832):
# pp=2 and sp=2 in bf16 and f32, and dp=2 x pp=2 and dp=2 x sp=2 in bf16 (four ranks)
PP_CELLS = {"pp2_vomix_bf16": ("bf16", 1, "pp", 2), "pp2_vomix_f32": ("f32", 1, "pp", 2),
            "sp2_vomix_bf16": ("bf16", 1, "sp", 2), "sp2_vomix_f32": ("f32", 1, "sp", 2),
            "dp2_pp2_vomix_bf16": ("bf16", 2, "pp", 2), "dp2_sp2_vomix_bf16": ("bf16", 2, "sp", 2)}
VOMIX_DEPTH = 8        # the full-width VoMix model's layers (sample_sp's); the recipe cells run PAR_DEPTH's
# sample_sp at sp=2 on a full-width acoustic model of the serving config (seeded random weights): 2 rows x
# 912 frames, cond_scale 0.7, 16 midpoint steps, f32 with TF32 off, against acoustic.sample on the card with
# the same noise. The reference's attention is the f32 flash kernel (tiled online softmax), sample_sp's the
# plain ring (f32 einsums over two blocks): both f32, the sums in another order. The sound reading was 6.7e-7
# of max |reference|; SAMPLE_SP_RTOL sits 15x above it. The same sample_sp with TF32 allowed (the ring's
# einsums and the dense layers at TF32's 10-bit mantissa) is the control: its error must exceed the bound, so
# a ring that lost f32 would fail the gate
SAMPLE_SP = {"rows": 2, "frames": 912, "cond_scale": 0.7, "seed": 19}
SAMPLE_SP_RTOL = 1e-5


def pp_per_step(dt, axis, size):
    """A rank step's flash launches: under pp, M + pp - 1 ticks of depth / pp
    layers, each one lse forward, dQ and dK/dV (and in bf16 one rotary
    pre-pass); none under sp (ring attention is plain PyTorch, as JAX's)."""
    if axis == "sp":
        return launches()
    k = (PP_MICROBATCHES + size - 1) * PAR_DEPTH["vomix"] // size
    return launches(fwd_lse=k, bwd_dq=k, bwd_dkv=k, **({"rotary": k} if dt == "bf16" else {}))


def pp_ppermutes(axis, size):
    """A rank step's ppermutes: under pp one a tick but the last, each way;
    under sp depth x (sp - 1) K / V hops and the two halos, each way."""
    from covomix_tpu_torch.parallel import pipeline as PP

    return PP.ppermutes_per_step(PP_MICROBATCHES, size) if axis == "pp" else 2 * (
        PAR_DEPTH["vomix"] * (size - 1) + 2)


def pp_syncs(dp, axis):
    """A rank step's gradient collectives: the shares added over the axis
    (one bucket), the dp mean when dp > 1, and under pp the sharded norm's
    scalar (the stacked leaves are split)."""
    return 1 + (dp > 1) + (axis == "pp")


def check_axis_collectives(mesh, axis) -> str:
    """ppermute by +1 and -1 (f32 and bf16) and axis_sum, forward and
    backward, on rank-valued device tensors over the mesh's pp or sp axis,
    each held to its arithmetic; returns the form the backend took."""
    import torch
    from covomix_tpu_torch.parallel import collectives as C, mesh as M

    group, n, i = mesh.axis_info(axis)
    r = i + 1.0
    for dtype in (torch.float32, torch.bfloat16):
        for shift in (1, -1):
            a = torch.full((2, 3), r, dtype=dtype, device="cuda", requires_grad=True)
            y, = C.ppermute(mesh, axis, [a], shift=shift)
            (y * r).sum().backward()
            if not (bool((y == (i - shift) % n + 1.0).all()) and bool((a.grad == (i + shift) % n + 1.0).all())):
                raise AssertionError(f"{axis} ppermute by {shift} ({dtype}) on device tensors: {y.tolist()}, "
                                     f"gradient {a.grad.tolist()}")
    x = torch.full((3,), r, device="cuda", requires_grad=True)
    y = C.axis_sum(mesh, axis, x)
    (y * r).sum().backward()
    if not (bool((y == n * (n + 1) / 2).all()) and bool((x.grad == r).all())):
        raise AssertionError(f"{axis} axis_sum on device tensors: {y.tolist()}, gradient {x.grad.tolist()}")
    name = M.backend(group)
    return f"{name}: batched isend / irecv " + ("on the device" if name == "nccl" else "of a host copy")


def sample_sp_inputs():
    """(config, seeded full-width parameters, phoneme ids, cond, noise) of
    the sample_sp cell, on the card."""
    import numpy as np
    import torch
    from covomix_tpu_torch.models import acoustic as A

    cfg = full_width_configs()[1]
    params = A.init(torch.Generator(device="cuda").manual_seed(SAMPLE_SP["seed"]), cfg)
    rs = np.random.RandomState(SAMPLE_SP["seed"])
    b, t = SAMPLE_SP["rows"], SAMPLE_SP["frames"]
    ph = torch.as_tensor(rs.randint(0, 500, (b, t, 2)), device="cuda")
    cond = torch.as_tensor((rs.randn(b, t, cfg.dim_in) * 0.1).astype(np.float32), device="cuda")
    noise = torch.as_tensor(rs.randn(b, t, cfg.mel_dim).astype(np.float32), device="cuda")
    return cfg, params, ph, cond, noise


def timed_sample(fn) -> tuple:
    """(fn()'s output, ms between synchronizes, flash launches, ppermutes)."""
    import torch
    from covomix_tpu_torch.parallel import collectives as C

    zero_counts()
    before = C.PPERMUTES
    torch.cuda.synchronize()
    t0 = time.time()
    y = fn()
    torch.cuda.synchronize()
    return y, (time.time() - t0) * 1e3, flash_counts(), C.PPERMUTES - before


def pp_cells(root, ref_dir, names, sample, out):
    """Phase 19's cells `names` as one rank on the one card over gloo, into
    `out`: for each mesh they use, phase 17's and this phase's collectives
    checked on device tensors; each cell on the rank's rows (its stage, or
    its frames), its gathered (and unstacked) parameters held against the
    one-process run's, its replicated parts against the first rank of each
    axis, the first-half skip placeholders of a first pp stage; with
    `sample`, sample_sp at sp=2 against the reference saved in ref_dir."""
    import dataclasses

    import torch
    from covomix_tpu_torch.parallel import pipeline as PP, ring as R
    from covomix_tpu_torch.parallel.mesh import gather_params, make_mesh

    cfg = dataclasses.replace(full_width_configs()[1], depth=PAR_DEPTH["vomix"])
    meshes = {}
    for name in names:
        dt, dp, axis, size = PP_CELLS[name]
        if (dp, axis) not in meshes:      # every rank builds the meshes (and their groups) in the same order
            mesh = meshes[dp, axis] = make_mesh(dp, "cuda", **{axis: size})
            out["forms"][f"{dp}x{axis}{size}"] = {**check_collectives(mesh), axis: check_axis_collectives(mesh, axis)}
        mesh = meshes[dp, axis]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        recs, state, lrs, specs = dp_train_cell(dp_args(root, "vomix", dt, f"--{axis}", str(size), "--pp_microbatches",
                                                        str(PP_MICROBATCHES)), DP_STEPS, mesh)
        wall = time.time() - t0
        params = gather_params(mesh, state.params, specs)
        if axis == "pp":
            params = PP.unstack_layer_params(params["stacked"], params["rest"], cfg)
        flat = flat_params(params)
        ref = torch.load(os.path.join(ref_dir, f"vomix_{dt}.pt")).to("cuda")
        rec = {"steps": recs, "lrs": lrs, "wall_s": wall, "dp_rank": mesh.dp_rank, "index": mesh.rank % mesh.n,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "replicas": replicas_equal(mesh, state, specs), "params": param_agreement(flat, ref, lrs, dt),
               "resident_bytes": resident_bytes(state)}
        if axis == "pp":      # the stage's first-half layers: zero placeholders, zero gradients, zero EMA
            lpp = cfg.depth // size
            skip = state.params["stacked"]["skip"]
            ema = state.ema_params["stacked"]["skip"]
            rec["skip_placeholders"] = {
                mesh.pp_rank * lpp + j: max(float(t[j].detach().abs().max()) for k in ("w", "b")
                                            for t in (skip[k], skip[k].grad, ema[k]))
                for j in range(lpp) if mesh.pp_rank * lpp + j < cfg.depth // 2}
        out[name] = rec
        del state, flat, ref, params
        torch.cuda.empty_cache()
    if sample:
        mesh = meshes.get((1, "sp")) or make_mesh(1, "cuda", sp=2)
        s_cfg, s_params, ph, cond, noise = sample_sp_inputs()
        y, ms, flash, pperm = timed_sample(lambda: R.sample_sp(s_params, s_cfg, None, ph, cond, mesh=mesh,
                                                               cond_scale=SAMPLE_SP["cond_scale"], noise=noise))
        with tf32_allowed():        # the lower-precision control
            y_tf32 = R.sample_sp(s_params, s_cfg, None, ph, cond, mesh=mesh, cond_scale=SAMPLE_SP["cond_scale"],
                                 noise=noise)
        ref = torch.load(os.path.join(ref_dir, "sample_sp.pt")).to("cuda")
        out["sample_sp"] = {"ms": ms, "launches": flash, "ppermutes": pperm, "shape": list(y.shape),
                            "finite": bool(torch.isfinite(y).all()), "max_abs_err": float((y - ref).abs().max()),
                            "tf32_max_abs_err": float((y_tf32 - ref).abs().max()),
                            "ref_max_abs": float(ref.abs().max())}


def parallel_rank(root, ref_dir, out_dir, tp_names, pp_names, sample, bmuf_names=(), serve_dp=False):
    """One rank of phases 18-20 on the one card over gloo: phase 18's
    cells `tp_names` (tp_cells), then phase 19's `pp_names` and, with
    `sample`, sample_sp (pp_cells), then phase 20's BMUF cells `bmuf_names`
    (bmuf_cells) and, with `serve_dp`, the dp serving cell
    (serve_dp_cells); the records into out_dir/rank<r>.json."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False      # as the reference process runs
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": dist.get_rank(), "device": f"cuda:{torch.cuda.current_device()}", "backend": dist.get_backend(),
           "forms": {}}
    tp_cells(root, ref_dir, tp_names, out)
    pp_cells(root, ref_dir, pp_names, sample, out)
    bmuf_cells(root, ref_dir, bmuf_names, out)
    if serve_dp:
        serve_dp_cells(out_dir, out)
    with open(os.path.join(out_dir, f"rank{out['rank']}.json"), "w") as f:
        json.dump(out, f)


def check_pp_cell(name, ranks, ref):
    """Phase 19's gates on every rank's record of one cell (module
    docstring, 19)."""
    dt, dp, axis, size = PP_CELLS[name]
    per_step = pp_per_step(dt, axis, size)
    want = {"ppermutes": pp_ppermutes(axis, size), "syncs": pp_syncs(dp, axis), "tp_collectives": 0,
            "param_gathers": 0}
    seen = set()
    for rank in ranks:
        got = rank[name]
        what = f"19 {name} rank {rank['rank']}"
        for i, (s, r) in enumerate(zip(got["steps"], ref["recs"])):
            for k in ("loss", "grad_norm"):
                if not abs(s[k] - r[k]) <= DP_RTOL[dt] * abs(r[k]):
                    raise AssertionError(f"{what} step {i + 1}: {k} {s[k]} vs one process {r[k]}")
            counts = {k: s[k] for k in want}
            if s["launches"] != per_step or counts != want or s["rows"] * dp != r["rows"]:
                raise AssertionError(f"{what} step {i + 1}: launches {s['launches']} (expected {per_step}), "
                                     f"collectives {counts} (expected {want}), {s['rows']} rows of {r['rows']}")
        p = got["params"]
        if not p["max_abs_err"] <= p["bound"] or (dt == "f32" and not p["tight_share"] <= DP_TIGHT_SHARE):
            raise AssertionError(f"{what}: parameters {p}")
        if not all(v is None or v["equal"] for v in got["replicas"].values()) or got["replicas"].get(axis) is None:
            raise AssertionError(f"{what}: replicated parts {got['replicas']}")
        placeholders = got.get("skip_placeholders", {})
        if any(v != 0.0 for v in placeholders.values()):
            raise AssertionError(f"{what}: first-half skip placeholders (max |param|, |grad|, |ema|) {placeholders}")
        seen |= {int(k) for k in placeholders}
    if axis == "pp" and seen != set(range(PAR_DEPTH["vomix"] // 2)):
        raise AssertionError(f"19 {name}: first-half skip placeholders checked for layers {sorted(seen)}")


def check_sample_sp(ranks, ref):
    """sample_sp's gates: each sp rank's gathered output finite, of the
    reference's shape, within SAMPLE_SP_RTOL of its max, and the TF32
    control beyond it; no flash launch in the timed call; 16 steps x 2
    field evaluations x (depth hops + 2 halos) ppermutes."""
    want = 16 * 2 * (VOMIX_DEPTH + 2)
    for rank in ranks:
        got = rank["sample_sp"]
        bound = SAMPLE_SP_RTOL * got["ref_max_abs"]
        if (not got["finite"] or got["shape"] != ref["shape"] or got["launches"] != launches()
                or got["ppermutes"] != want or not got["max_abs_err"] <= bound < got["tf32_max_abs_err"]):
            raise AssertionError(f"19 sample_sp rank {rank['rank']}: {got} (reference {ref}; {want} ppermutes)")


def check_pp(results, spawns, refs, names, sample_ref):
    """Phase 19's records of every rank held by check_pp_cell (and, with
    `sample_ref`, check_sample_sp), logged and kept in results["pp"]."""
    pp = {"card": card_line(), "microbatches": PP_MICROBATCHES, "cells": {},
          "forms": {k: v for sp in spawns.values() for k, v in sp["ranks"][0]["forms"].items()
                    if not k.split("x")[1].isdigit()}}
    for name in names:
        dt, dp, axis, size = PP_CELLS[name]
        ranks = spawns[dp * size]["ranks"]
        ref = refs[f"vomix_{dt}"]
        check_pp_cell(name, ranks, ref)
        steps = [rank[name]["steps"] for rank in ranks]
        pp["cells"][name] = {
            "one_process_ms": [round(s["ms"], 3) for s in ref["recs"]],
            "ms": [[round(s["ms"], 3) for s in st] for st in steps],
            "ppermutes_per_step": steps[0][0]["ppermutes"], "ppermute_bytes_per_step": steps[0][0]["ppermute_bytes"],
            "ppermute_ms": [[round(s["ppermute_ms"], 3) for s in st] for st in steps],
            "grad_syncs_per_step": steps[0][0]["syncs"], "grad_sync_bytes_per_step": steps[0][0]["sync_bytes"],
            "resident_bytes": [rank[name]["resident_bytes"] for rank in ranks],
            "peak_gib": [round(rank[name]["peak_gib"], 3) for rank in ranks],
            "wall_s": [round(rank[name]["wall_s"], 3) for rank in ranks],
            "params": ranks[0][name]["params"], "replicas": [rank[name]["replicas"] for rank in ranks],
            "loss_rel_err": max(abs(s["loss"] - r["loss"]) / abs(r["loss"])
                                for st in steps for s, r in zip(st, ref["recs"])),
            "launches_per_step": steps[0][0]["launches"], "rows_per_rank": steps[0][0]["rows"],
            "depth": PAR_DEPTH["vomix"]}
        log(f"19 {name} ({pp['card']}): " + json.dumps(pp["cells"][name]))
    if sample_ref is not None:
        check_sample_sp(spawns[2]["ranks"], sample_ref)
        pp["sample_sp"] = {"reference": sample_ref, "ranks": [rank["sample_sp"] for rank in spawns[2]["ranks"]],
                           "rtol_of_max": SAMPLE_SP_RTOL, **SAMPLE_SP}
        log(f"19 sample_sp sp=2 ({pp['card']}): " + json.dumps(pp["sample_sp"]))
    results["pp"] = pp
    results["pp_launches"] = {name: c["launches_per_step"] for name, c in pp["cells"].items()}
    log(f"phase 19 collective forms {json.dumps(pp['forms'])}")

# ---------------------------------------------------------------------------
# phase 20: BMUF training and dialogue serving over dp at full width

BMUF_STEPS = 4
BMUF_SYNC, BMUF_WARMUP = 2, 1      # step 1 the warmup sync, steps 2 and 4 block syncs, step 3 local
# (cell, dtype) of phase 20's BMUF cells at dp=2, the default block momentum 1 - 1/2
BMUF_CELLS = {"bmuf_vomix_bf16": ("vomix", "bf16"), "bmuf_vomix_f32": ("vomix", "f32"),
              "bmuf_t2s_bf16": ("t2s", "bf16")}
# BatchedPipeline(mesh=) at dp=2 on phase 4's serving models: global B 8 (4 rows a rank, 8 with CFG in the
# flow), 400-frame prompts, 512 decode steps (min_length 512), against the one-process pipeline on the same
# inputs and generator seed. A rank runs every GEMM and convolution at half the rows, where cuBLAS and cuDNN
# may pick other kernels (sums in another order): in f32 (TF32 off) the tokens must still be equal (a flip
# needs a Gumbel-perturbed near-tie at ~1e-6) and the wav within SERVE_DP_WAV_TOL of max |wav| (16 midpoint
# steps of 8 layers, then the vocoder, carry ~1e-6 relative differences); in bf16 the tokens are held by
# hold_tokens' near-tie rule and the wav on the rows whose tokens match
SERVE_DP = {"batch": 8, "prompt": 400, "decode": 512, "text_len": 64, "seed": 20}
SERVE_DP_DTYPES = ("f32", "bf16")
SERVE_DP_WARM = ("bf16",)       # timed after a warm-up call; f32's timed call includes the decode's capture
# the wav bounds, of max |wav| (first card reading, PR 19: f32 2.8e-7, bf16 6.1e-3): f32 1e-5, 36x the reading; bf16
# 2^-6, 4 of bf16's ulps at the top of the wav's binade (the reading is one ulp: the output rounded to bf16)
SERVE_DP_WAV_TOL = {"f32": 1e-5, "bf16": 2 ** -6}


def bmuf_args(root, cell, dt):
    """The train CLI's flags of a phase 20 BMUF cell (dp=2, sync 2, warmup 1)."""
    return dp_args(root, cell, dt, "--dp", "2", "--bmuf_sync", str(BMUF_SYNC), "--bmuf_warmup", str(BMUF_WARMUP))


def bmuf_setup(args):
    """What the train CLI builds for a BMUF run: (the parameters drawn from
    --seed, the plain loss (no dp mesh: a rank's loss is its own rows'), the
    loader of the global batch, the TrainConfig, the BMUFConfig)."""
    import torch
    from covomix_tpu_torch.data.datasets import data_loader
    from covomix_tpu_torch.parallel import bmuf as BM
    from covomix_tpu_torch.train import cli

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    _, params, loss_fn = cli.build_model(args, gen, None)
    dataset, _ = cli._datasets(args)
    loader = data_loader(dataset, args.batch_size, cli.build_collate(args)[0], seed=args.seed)
    tcfg = cli.train_config(args, max(1, len(dataset) // args.batch_size))
    bcfg = BM.BMUFConfig(sync_every=args.bmuf_sync, warmup_steps=args.bmuf_warmup, block_momentum=args.bmuf_momentum)
    return params, loss_fn, loader, tcfg, bcfg


def bits_checksum(flat):
    """[2] int64 checksums of a flat f32 tensor's bit patterns: their sum and
    a sum weighted by position mod 7 (+ 1), both exact (|bits| < 2^31, 8 x
    2^31 x 250.5 M < 2^63): bit-equal tensors give equal checksums, and a
    tensor that differs anywhere gives others unless the differences cancel
    in both sums."""
    import torch

    bits = flat.view(torch.int32).to(torch.int64)
    weights = torch.arange(bits.numel(), device=bits.device) % 7 + 1
    return torch.stack([bits.sum(), (bits * weights).sum()])


def bmuf_reference(root, ref_dir, name):
    """A BMUF cell in one process: the two workers' local steps one after the
    other (each on its rows of the global batch, with its own generator,
    Adam at the schedule's value of its own count), then the BMUF update on
    the stack of their models in plain PyTorch (rank 0's model at the
    warmup, with both Adam states reset; the block update with the default
    momentum at the syncs), then each worker's EMA. Saves each worker's
    final parameters (flat) and the steps' mean loss and grad norm, the
    learning rates and branches to ref_dir."""
    import torch
    from covomix_tpu_torch.parallel import bmuf as BM
    from covomix_tpu_torch.train import loop
    from covomix_tpu_torch.train.gan import opt_count
    from covomix_tpu_torch.util.misc import tree_leaves, tree_map

    cell, dt = BMUF_CELLS[name]
    args = bmuf_args(root, cell, dt)
    params, loss_fn, loader, tcfg, bcfg = bmuf_setup(args)
    dp = args.dp
    workers = [loop.init_train_state(tree_map(lambda p: p.detach().clone(), params), tcfg) for _ in range(dp)]
    gens = [BM.rank_generator("cuda", args.seed, w) for w in range(dp)]
    vg, schedule = loop.accumulated_value_and_grad(loss_fn, 1), loop.reference_lr_schedule(tcfg)
    bm = bcfg.resolved_momentum(dp)
    flat = lambda st: torch.cat([t.detach().reshape(-1) for t in tree_leaves(st.params)])
    glob = flat(workers[0])
    smoothed = torch.zeros_like(glob)
    recs = []
    for i in range(BMUF_STEPS):
        batch = next(loader)
        b = len(next(iter(batch.values()))) // dp
        losses, norms, lrs = [], [], []
        for w, st in enumerate(workers):
            loss, grads = vg(st.params, loop.to_device({k: v[w * b:(w + 1) * b] for k, v in batch.items()}, "cuda"),
                             gens[w])
            lr = schedule(opt_count(st.optimizer))
            for group in st.optimizer.param_groups:
                group["lr"] = lr
            st.optimizer.step()
            losses.append(float(loss))
            norms.append(float(loop.global_norm(grads)))
            lrs.append(lr)
        kind = BM.branch(i + 1, bcfg)
        if kind == "warmup_sync":
            glob = flat(workers[0])
            smoothed.zero_()
            for st in workers:
                st.optimizer.state.clear()
        elif kind == "block_sync":
            grad = sum(glob - flat(st) for st in workers) / dp
            smoothed = smoothed * bm + grad * bcfg.block_lr
            glob = (glob - smoothed) - smoothed * bm
        if kind != "noop":
            with torch.no_grad():
                for st in workers:
                    offset = 0
                    for t in tree_leaves(st.params):
                        t.copy_(glob[offset: offset + t.numel()].view_as(t))
                        offset += t.numel()
        for st in workers:
            loop.ema_update(st.ema_params, st.params, st.ema_num_updates, tcfg.ema_decay)
            st.ema_num_updates += 1
            st.step += 1
        recs.append({"loss": sum(losses) / dp, "grad_norm": sum(norms) / dp, "lrs": lrs, "branch": kind})
    for w, st in enumerate(workers):
        torch.save(flat(st).cpu(), os.path.join(ref_dir, f"{name}_w{w}.pt"))
    with open(os.path.join(ref_dir, f"{name}.json"), "w") as f:
        json.dump({"recs": recs, "lrs": [r["lrs"][0] for r in recs]}, f)


def bmuf_cells(root, ref_dir, names, out):
    """Phase 20's BMUF cells `names` as one rank of dp=2 on the one card over
    gloo, into `out`: BMUF_STEPS steps each (`parallel/bmuf.make_bmuf_train_step`
    as the train CLI drives it), every step timed with its launches, gradient
    all-reduces, BMUF sync collectives (count, bytes, host ms), the ranks'
    parameters compared by checksum, Adam's count and state; the final
    parameters against the worker's of the one-process reference; resident
    bytes and peak GiB."""
    import torch
    from covomix_tpu_torch.parallel import bmuf as BM, train_step as TS
    from covomix_tpu_torch.parallel.mesh import all_gather, make_mesh, replicate
    from covomix_tpu_torch.train import loop
    from covomix_tpu_torch.train.gan import opt_count
    from covomix_tpu_torch.util.misc import tree_leaves

    if not names:
        return
    mesh = make_mesh(2, "cuda")
    for name in names:
        cell, dt = BMUF_CELLS[name]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        args = bmuf_args(root, cell, dt)
        params, loss_fn, loader, tcfg, bcfg = bmuf_setup(args)
        replicate(mesh, tree_leaves(params))
        state = loop.init_train_state(params, tcfg)
        bstate = BM.init_bmuf_state(state.params)
        step = BM.make_bmuf_train_step(loss_fn, tcfg, bcfg, mesh, bstate)
        gen = BM.rank_generator("cuda", args.seed, mesh.dp_rank)
        recs = []
        for i in range(BMUF_STEPS):
            batch = TS.shard_batch(mesh, next(loader))
            before = (BM.SYNCS, BM.SYNC_BYTES, BM.SYNC_SECONDS)
            rec = timed_step(step, state, batch, gen)
            sums = all_gather(bits_checksum(flat_params(state.params))[None], 0, mesh.dp_group, mesh.dp, mesh.dp_rank)
            rec.update(branch=BM.branch(i + 1, bcfg), rows=len(next(iter(batch.values()))),
                       bmuf_syncs=BM.SYNCS - before[0], bmuf_bytes=BM.SYNC_BYTES - before[1],
                       bmuf_ms=(BM.SYNC_SECONDS - before[2]) * 1e3, params_equal=bool((sums == sums[0]).all()),
                       adam_count=opt_count(state.optimizer), adam_states=len(state.optimizer.state))
            recs.append(rec)
        wall = time.time() - t0
        flat = flat_params(state.params)
        ref = torch.load(os.path.join(ref_dir, f"{name}_w{mesh.dp_rank}.pt")).to("cuda")
        with open(os.path.join(ref_dir, f"{name}.json")) as f:
            lrs = json.load(f)["lrs"]
        size = lambda tree: sum(t.numel() * t.element_size() for t in tree_leaves(tree))
        out[name] = {"steps": recs, "wall_s": wall, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "params": param_agreement(flat, ref, lrs, dt), "param_bytes": size(state.params),
                     "resident_bytes": {**resident_bytes(state), "bmuf_global": size(bstate["global"]),
                                        "bmuf_smoothed": size(bstate["smoothed"])}}
        del state, bstate, flat, ref, params
        torch.cuda.empty_cache()


def serve_dp_pipe(dt, mesh=None):
    """BatchedPipeline on phase 4's serving models (full width, seed 0) at
    SERVE_DP's shape in `dt`: one process, or over `mesh`."""
    import torch
    from covomix_tpu_torch.models import acoustic as A, text2semantic as T, vocoder as V
    from covomix_tpu_torch.serving import BatchedPipeline

    t2s_cfg, ac_cfg, voc_cfg = full_width_configs()
    g = torch.Generator(device="cuda").manual_seed(0)
    return BatchedPipeline(T.init(g, t2s_cfg), t2s_cfg, A.init(g, ac_cfg), ac_cfg, V.init_generator(g, voc_cfg),
                           voc_cfg, decode_len=SERVE_DP["decode"], cond_scale=0.7,
                           dtype=torch.bfloat16 if dt == "bf16" else torch.float32, min_length=SERVE_DP["decode"],
                           device="cuda" if mesh is None else mesh.device, mesh=mesh)


def serve_dp_call(pipe, warm=True) -> dict:
    """One seeded call of a phase 20 pipeline (after a warm-up call that
    captures the decode's graph, with `warm`; without, the timed call
    captures it): its wav and GenerateResult on the host, the generator's
    next draw, ms between synchronizes and the flash launches."""
    import torch

    placed = pipe.place(*serving_inputs(SERVE_DP["batch"], SERVE_DP["prompt"], SERVE_DP["text_len"], 160,
                                        SERVE_DP["seed"]))
    if warm:
        pipe(torch.Generator(device="cuda").manual_seed(SERVE_DP["seed"]), *placed)
    gen = torch.Generator(device="cuda").manual_seed(SERVE_DP["seed"])
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    wav, res = pipe(gen, *placed)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    counts = flash_counts()
    return {"wav": wav.float().cpu(), "tokens": res.tokens.cpu(), "tokens2": res.tokens2.cpu(),
            "lengths": res.lengths.cpu(), "lengths2": res.lengths2.cpu(), "num_steps": res.num_steps,
            "next_draw": torch.rand(4, generator=gen, device="cuda").cpu(), "ms": ms, "launches": counts}


def serve_dp_cells(out_dir, out):
    """Phase 20's serving cell as one rank of dp=2 on the one card over
    gloo: the dp pipeline's seeded call in each of SERVE_DP_DTYPES, its
    gathered results saved to out_dir for the parent to hold, its ms and
    launches into `out`."""
    import torch
    from covomix_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, "cuda")
    for dt in SERVE_DP_DTYPES:
        torch.cuda.reset_peak_memory_stats()
        r = serve_dp_call(serve_dp_pipe(dt, mesh), warm=dt in SERVE_DP_WARM)
        torch.save(r, os.path.join(out_dir, f"serve_dp_{dt}_rank{mesh.rank}.pt"))
        out[f"serve_dp_{dt}"] = {"ms": r["ms"], "launches": r["launches"], "num_steps": r["num_steps"],
                                 "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        torch.cuda.empty_cache()


def check_bmuf(results, ranks, refs, names):
    """Phase 20's BMUF gates on both ranks' records (module docstring, 20),
    logged and kept in results["bmuf"]."""
    bmuf = {"card": card_line(), "cells": {}}
    for name in names:
        cell, dt = BMUF_CELLS[name]
        per_step, ref = DP_PER_STEP[cell][dt], refs[name]
        for rank in ranks:
            got = rank[name]
            what = f"20 {name} rank {rank['rank']}"
            for i, (s, r) in enumerate(zip(got["steps"], ref["recs"])):
                sync = s["branch"] != "noop"
                want = {"branch": r["branch"], "launches": per_step, "syncs": 0, "bmuf_syncs": int(sync),
                        "bmuf_bytes": got["param_bytes"] if sync else 0, "params_equal": sync}
                have = {k: s[k] for k in want}
                if have != want or not all(abs(s[k] - r[k]) <= DP_RTOL[dt] * abs(r[k]) for k in ("loss", "grad_norm")):
                    raise AssertionError(f"{what} step {i + 1}: {have} (expected {want}); loss {s['loss']} grad norm "
                                         f"{s['grad_norm']} vs one process {r['loss']} / {r['grad_norm']}")
                if s["branch"] == "warmup_sync" and (s["adam_count"], s["adam_states"]) != (0, 0):
                    raise AssertionError(f"{what}: Adam not reset at the warmup: count {s['adam_count']}, "
                                         f"{s['adam_states']} leaves with state")
            p = got["params"]
            if not p["max_abs_err"] <= p["bound"] or (dt == "f32" and not p["tight_share"] <= DP_TIGHT_SHARE):
                raise AssertionError(f"{what}: parameters {p}")
        steps = [rank[name]["steps"] for rank in ranks]
        bmuf["cells"][name] = {
            "ms": [[round(s["ms"], 3) for s in st] for st in steps],
            "local_ms": [[round(s["ms"], 3) for s in st if s["branch"] == "noop"] for st in steps],
            "sync_ms": [[round(s["ms"], 3) for s in st if s["branch"] != "noop"] for st in steps],
            "sync_collectives_per_step": [s["bmuf_syncs"] for s in steps[0]],
            "sync_bytes_per_sync": ranks[0][name]["param_bytes"],
            "sync_host_ms": [[round(s["bmuf_ms"], 3) for s in st if s["branch"] != "noop"] for st in steps],
            "branches": [s["branch"] for s in steps[0]], "lrs": ref["lrs"],
            "resident_bytes": [rank[name]["resident_bytes"] for rank in ranks],
            "peak_gib": [round(rank[name]["peak_gib"], 3) for rank in ranks],
            "wall_s": [round(rank[name]["wall_s"], 3) for rank in ranks], "params": ranks[0][name]["params"],
            "loss_rel_err": max(abs(s["loss"] - r["loss"]) / abs(r["loss"]) for st in steps
                                for s, r in zip(st, ref["recs"])),
            "launches_per_step": steps[0][0]["launches"], "rows_per_rank": steps[0][0]["rows"],
            "depth": PAR_DEPTH[BMUF_CELLS[name][0]]}
        log(f"20 {name} ({bmuf['card']}): " + json.dumps(bmuf["cells"][name]))
    results["bmuf"] = bmuf
    results["bmuf_launches"] = {name: c["launches_per_step"] for name, c in bmuf["cells"].items()}


def serve_dp_reference(ref_dir):
    """The one-process pipeline's seeded call in each dtype (after its
    warm-up), saved to ref_dir."""
    import torch

    for dt in SERVE_DP_DTYPES:
        r = serve_dp_call(serve_dp_pipe(dt), warm=dt in SERVE_DP_WARM)
        torch.save(r, os.path.join(ref_dir, f"serve_dp_{dt}.pt"))
        torch.cuda.empty_cache()


def check_serve_dp(results, ranks, ref_dir, out_dir):
    """Phase 20's serving gates (module docstring, 20): each rank's gathered
    result against the one process's, the two ranks' wavs bit for bit,
    256 forwards (and in bf16 256 pre-passes) per rank call; logged and kept
    in results["serve_dp"]."""
    import torch

    serve = {"card": card_line(), **SERVE_DP, "wav_tol_of_max": SERVE_DP_WAV_TOL, "cells": {}}
    for dt in SERVE_DP_DTYPES:
        ref = torch.load(os.path.join(ref_dir, f"serve_dp_{dt}.pt"))
        got = [torch.load(os.path.join(out_dir, f"serve_dp_{dt}_rank{r}.pt")) for r in range(2)]
        want = launches(fwd=256, **({"rotary": 256} if dt == "bf16" else {}))
        what = f"20 serving dp=2 {dt}"
        if ref["launches"] != want or any(g["launches"] != want for g in got):
            raise AssertionError(f"{what}: launches {[g['launches'] for g in got]}, one process {ref['launches']}, "
                                 f"expected {want}")
        if not torch.equal(got[0]["wav"], got[1]["wav"]):
            raise AssertionError(f"{what}: the two ranks' gathered wavs differ")
        for r, x in enumerate(got):
            if x["num_steps"] != ref["num_steps"] or not torch.equal(x["next_draw"], ref["next_draw"]):
                raise AssertionError(f"{what} rank {r}: {x['num_steps']} steps (one process {ref['num_steps']}), "
                                     f"next draw {x['next_draw'].tolist()} vs {ref['next_draw'].tolist()}")
        g = got[0]
        same = [r for r in range(ref["tokens"].shape[0])
                if all(torch.equal(g[k][r], ref[k][r]) for k in ("tokens", "tokens2", "lengths", "lengths2"))]
        ties = []
        if len(same) != ref["tokens"].shape[0]:
            if dt == "f32":
                raise AssertionError(f"{what}: tokens differ from one process's in rows "
                                     f"{sorted(set(range(ref['tokens'].shape[0])) - set(same))}")
            ties = hold_dp_tokens(what, g)
        scale = float(ref["wav"].abs().max())
        err = float((g["wav"][same] - ref["wav"][same]).abs().max()) if same else 0.0
        if not (torch.isfinite(g["wav"]).all() and err <= SERVE_DP_WAV_TOL[dt] * scale):
            raise AssertionError(f"{what}: wav max abs error {err} on rows {same}, bound "
                                 f"{SERVE_DP_WAV_TOL[dt]} x {scale}")
        serve["cells"][dt] = {"one_process_ms": ref["ms"], "ms": [x["ms"] for x in got], "launches": g["launches"],
                              "num_steps": g["num_steps"], "rows_equal": len(same), "ties": ties,
                              "wav_max_abs_err": err, "wav_max_abs": scale, "wav_shape": list(g["wav"].shape)}
        log(f"{what} ({serve['card']}): " + json.dumps(serve["cells"][dt], default=str))
    results["serve_dp"] = serve
    results["serve_dp_launches"] = {dt: c["launches"] for dt, c in serve["cells"].items()}


def hold_dp_tokens(what, got):
    """bf16: the dp tokens against the one-process call redone with its
    decode uncaptured under GreedyLogits (the scores it sampled from), by
    hold_tokens' near-tie rule."""
    from types import SimpleNamespace

    import torch

    pipe = serve_dp_pipe("bf16")
    with GreedyLogits() as logits:
        ref = serve_dp_call(pipe, warm=False)
    to_res = lambda r: SimpleNamespace(tokens=r["tokens"], tokens2=r["tokens2"], num_steps=r["num_steps"])
    del pipe
    torch.cuda.empty_cache()
    return hold_tokens(f"{what}: dp=2 vs one process", to_res(ref), to_res(got), logits)



def run_parallel_training(results, root, tp_names=tuple(TP_CELLS), axes=("pp", "sp"),
                          bmuf_names=tuple(BMUF_CELLS), serve_dp=True):
    """Phases 18-20 at full width on phase 17's items (`write_dp_items`)
    and its one-process references, each computed here when absent (`--tp`,
    `--pp`, `--sp`, `--bmuf`, `--serve_dp` alone): phase 18's cells
    `tp_names`, phase 19's cells of `axes` (and, with sp, sample_sp against
    acoustic.sample, computed here), phase 20's BMUF cells `bmuf_names`
    (bmuf_reference here) and, with `serve_dp`, the dp serving cell
    (serve_dp_reference here); the two-rank cells in one spawn of two ranks
    on this card over gloo, the four-rank ones in one spawn of four (one
    start-up per world size); every rank's records held by check_tp /
    check_pp / check_bmuf / check_serve_dp. The kernel library is built
    before the ranks start."""
    import torch
    from covomix_tpu_torch.models import acoustic as A
    from covomix_tpu_torch.ops import flash_attention as FA
    from covomix_tpu_torch.parallel import multihost as MH

    t_start = time.time()
    FA.KERNEL.build(64)
    ref_dir, out_dir = os.path.join(root, "ref"), os.path.join(root, "parallel_ranks")
    os.makedirs(ref_dir, exist_ok=True)
    pp_names = [n for n, c in PP_CELLS.items() if c[2] in axes]
    refs = {}
    for cell, dt in sorted({TP_CELLS[n][:2] for n in tp_names} | {("vomix", PP_CELLS[n][0]) for n in pp_names}):
        key = f"{cell}_{dt}"
        if not os.path.exists(os.path.join(ref_dir, f"{key}.json")):
            recs, state, lrs, _ = dp_train_cell(dp_args(root, cell, dt), DP_STEPS)
            save_reference(ref_dir, key, flat_params(state.params), recs, lrs)
            del state
            torch.cuda.empty_cache()
        with open(os.path.join(ref_dir, f"{key}.json")) as f:
            refs[key] = json.load(f)
    sample_ref = None
    if "sp" in axes:
        s_cfg, s_params, ph, cond, noise = sample_sp_inputs()
        y, ms, flash, _ = timed_sample(lambda: A.sample(s_params, s_cfg, None, ph, cond,
                                                        cond_scale=SAMPLE_SP["cond_scale"], noise=noise))
        torch.save(y.cpu(), os.path.join(ref_dir, "sample_sp.pt"))
        sample_ref = {"ms": ms, "launches": flash, "shape": list(y.shape), "max_abs": float(y.abs().max())}
        del s_params, y
        torch.cuda.empty_cache()
    t20 = time.time()
    for name in bmuf_names:
        bmuf_reference(root, ref_dir, name)
        torch.cuda.empty_cache()
    if serve_dp:
        serve_dp_reference(ref_dir)
    refs20_s = time.time() - t20
    spawns = {}
    for world in (2, 4):
        tn = [n for n in tp_names if TP_CELLS[n][2] * TP_CELLS[n][3] == world]
        pn = [n for n in pp_names if PP_CELLS[n][1] * PP_CELLS[n][3] == world]
        sample = sample_ref is not None and world == 2
        bn, sd = (list(bmuf_names), serve_dp) if world == 2 else ([], False)
        if not (tn or pn or sample or bn or sd):
            continue
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        t0 = time.time()
        MH.spawn(parallel_rank, world, root, ref_dir, out_dir, tn, pn, sample, bn, sd, device="cuda", backend="gloo")
        spawns[world] = {"s": time.time() - t0, "ranks": []}
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                spawns[world]["ranks"].append(json.load(f))
        if sd:      # the gathered results, held here before the next spawn empties out_dir
            check_serve_dp(results, spawns[world]["ranks"], ref_dir, out_dir)
    if tp_names:
        check_tp(results, spawns, refs, tp_names)
    if pp_names or sample_ref is not None:
        check_pp(results, spawns, refs, pp_names, sample_ref)
    if bmuf_names:
        bmuf_refs = {}
        for name in bmuf_names:
            with open(os.path.join(ref_dir, f"{name}.json")) as f:
                bmuf_refs[name] = json.load(f)
        check_bmuf(results, spawns[2]["ranks"], bmuf_refs, bmuf_names)
    wall = {"wall_s": time.time() - t_start, "spawn_s": {w: v["s"] for w, v in spawns.items()},
            "phase20_references_s": refs20_s,
            "cells_s": {name: max(rank[name]["wall_s"] for rank in spawns[world]["ranks"])
                        for world, sp in spawns.items() for name in sp["ranks"][0] if name in TP_CELLS or
                        name in PP_CELLS or name in BMUF_CELLS}}
    results["parallel_wall"] = wall
    log(f"phases 18-20 wall {wall['wall_s']:.1f} s at depth {json.dumps(PAR_DEPTH)} (phase 20's one-process "
        f"references {refs20_s:.1f} s; the ranks "
        f"{json.dumps(wall['spawn_s'])} s; each cell's slowest rank {json.dumps(wall['cells_s'])} s)")


# ---------------------------------------------------------------------------
# phase 21: data preparation and the file-level evals

EVAL_SECONDS = (12.2, 15.7, 19.3)   # 8 kHz wavs: 611-966 mel frames, every file on the flash route (>= 512)
EVAL_FILES = 2                       # num_eval_files of each file-level eval
EVAL_T2S_MAX_LENGTH = 512            # the file-level T2S eval's decode, cut from its default 2048
ADAPTIVE_SHAPE = (1, 912)            # sample_adaptive (bf16) and sample_regression (f32): B, T
ADAPTIVE_MAX_STEPS = 64
# prepare_mels on the card against the port on the CPU, TF32 off: the STFT's
# 480-tap sums and the 241-bin projection in another order, in the log
# domain (the CPU port reads ~1e-5 against the JAX package's)
MEL_CARD_TOL = 1e-4
# evaluate_metrics' numbers (rounded to 3-4 places) with the mels on the card
# against the mels on the CPU: only MCD reads the mels
METRICS_CARD_TOL = 1e-3
# stft_complex / istft and light / dynamic convolution card vs CPU, f32 with
# TF32 off: summation order only, x max(1, max |cpu|)
SPEC_CARD_TOL = 1e-5
LIGHTCONV_CARD_TOL = 1e-5
# the small f32 sample_adaptive, card vs CPU: equal attempts, y within this x max |y|
ADAPTIVE_CPU_TOL = 1e-4
EVAL_TEXTS = ("hello there, how are you doing today?", "i am fine, thank you [laughter] and you?",
              "good to hear [spkchange] see you soon")


def eval_wave(rs, seconds, f0, sr=8000):
    """A seeded voiced-like wave: eight harmonics of f0 under a syllable-rate
    envelope, with noise."""
    import numpy as np

    t = np.arange(int(sr * seconds)) / sr
    x = sum(np.sin(2 * np.pi * h * f0 * t + rs.rand()) / h for h in range(1, 9))
    return 0.2 * x * (0.5 + 0.5 * np.sin(2 * np.pi * (2.5 + rs.rand()) * t)) + 0.02 * rs.randn(len(t))


def write_eval_wavs(root, seed=21):
    """Seeded 8 kHz wavs under root/wavs: VoSingle utterances `single/
    fe_03_00001-0k.wav` of EVAL_SECONDS, and VoMix streams `mix/u{k}-A.wav`,
    `u{k}-B.wav` (two voices) with their sum `u{k}.wav` as the mix."""
    import numpy as np
    from covomix_tpu_torch.audio import save_wav

    rs = np.random.RandomState(seed)
    for sub in ("single", "mix"):
        os.makedirs(os.path.join(root, "wavs", sub), exist_ok=True)
    for k, s in enumerate(EVAL_SECONDS):
        save_wav(os.path.join(root, "wavs", "single", f"fe_03_00001-{k:02d}.wav"),
                 eval_wave(rs, s, 120 + 15 * k).astype(np.float32), 8000)
        a, b = eval_wave(rs, s, 110 + 10 * k), eval_wave(rs, s, 190 + 10 * k)
        for name, x in ((f"u{k}-A", a), (f"u{k}-B", b), (f"u{k}", np.clip(a + b, -1, 1))):
            save_wav(os.path.join(root, "wavs", "mix", f"{name}.wav"), x.astype(np.float32), 8000)


def prepare_eval_data(results, root, seed=21):
    """Phase 21's data, built by the port: the wavs, then `prepare_mels
    --device cuda` into root/data (subpaths mirrored), held against `--device
    cpu` (MEL_CARD_TOL), then seeded code siblings (string arrays: VoSingle
    `.hubert_code.npy` two frames longer than the mel, VoMix `-A` / `-B`
    `-16k.hubert_code.npy`) and `.txt` files for the T2S eval (`x.txt`
    beside `x.hubert_code.npy`, `u0-A.txt` beside `u0-A-16k.hubert_code.npy`).
    Returns (VoSingle mel files, VoMix mixed mel files, T2S code files)."""
    import glob

    import numpy as np
    from covomix_tpu_torch import prepare_mels as PM

    t0 = time.time()
    write_eval_wavs(root, seed)
    wavs = os.path.join(root, "wavs")
    timings = {"wavs_s": time.time() - t0}
    for dev, out in (("cuda", "data"), ("cpu", "data_cpu")):
        t0 = time.time()
        PM.main(["--data_path", wavs, "--save_path", os.path.join(root, out), "--device", dev])
        timings[f"prepare_mels_{dev}_s"] = time.time() - t0
    data = os.path.join(root, "data")
    names = sorted(os.path.relpath(p, data) for p in glob.glob(os.path.join(data, "**", "*.mel.npy"), recursive=True))
    cpu_names = sorted(os.path.relpath(p, os.path.join(root, "data_cpu"))
                       for p in glob.glob(os.path.join(root, "data_cpu", "**", "*.mel.npy"), recursive=True))
    if names != cpu_names or len(names) != 4 * len(EVAL_SECONDS):
        raise AssertionError(f"prepare_mels wrote {names} on the card and {cpu_names} on the CPU")
    errs = {}
    for name in names:
        card, cpu = np.load(os.path.join(data, name)), np.load(os.path.join(root, "data_cpu", name))
        if card.shape != cpu.shape or card.dtype != np.float32 or not np.isfinite(card).all():
            raise AssertionError(f"{name}: card {card.shape} {card.dtype}, cpu {cpu.shape}")
        errs[name] = float(np.abs(card - cpu).max())
    worst = max(errs.values())
    log(f"21 prepare_mels --device cuda: {len(names)} mels (frames {sorted({np.load(os.path.join(data, n)).shape[1] for n in names})}); "
        f"card vs CPU max |diff| {worst:.3e} (tol {MEL_CARD_TOL:g}) {'ok' if worst <= MEL_CARD_TOL else 'FAIL'}; "
        f"walls {json.dumps(timings)}")
    if worst > MEL_CARD_TOL:
        raise AssertionError(f"prepare_mels card vs CPU: {errs}")
    rs = np.random.RandomState(seed + 1)
    single = sorted(glob.glob(os.path.join(data, "single", "*.mel.npy")))
    for path in single:
        frames = np.load(path).shape[1]
        np.save(path.replace(".mel.npy", ".hubert_code.npy"), rs.randint(0, 500, frames + 2).astype(str))
    mixed = []
    for k in range(len(EVAL_SECONDS)):
        base = os.path.join(data, "mix", f"u{k}")
        for side in ("-A", "-B"):
            frames = np.load(base + side + ".mel.npy").shape[1]
            np.save(base + side + "-16k.hubert_code.npy", rs.randint(0, 500, frames).astype(str))
        mixed.append(base + ".mel.npy")
    codes = [single[0].replace(".mel.npy", ".hubert_code.npy"), os.path.join(data, "mix", "u0-A-16k.hubert_code.npy")]
    for path, text in zip((single[0].replace(".mel.npy", ".txt"), os.path.join(data, "mix", "u0-A.txt")), EVAL_TEXTS):
        with open(path, "w") as f:
            f.write(text + "\n")
    results["data_prep"] = {"mel_card_vs_cpu_max_abs_diff": worst, **timings}
    return single, mixed, codes


def run_eval_metrics(results, root):
    """`evaluate_metrics --device cuda` on 4 pairs (three VoSingle wavs and a
    VoMix mix against noisy copies named `_generated`, one unmatched file):
    4 rows, every number finite, the `# key: m +- s` trailer; the same run
    with `--device cpu` within METRICS_CARD_TOL."""
    import csv

    import numpy as np
    from covomix_tpu_torch import evaluate_metrics as EM
    from covomix_tpu_torch.audio import load_wav, save_wav

    rs = np.random.RandomState(5)
    gen, ref = os.path.join(root, "metrics_gen"), os.path.join(root, "metrics_ref")
    os.makedirs(gen), os.makedirs(ref)
    srcs = sorted(os.listdir(os.path.join(root, "wavs", "single"))) + ["u1.wav"]
    for i, name in enumerate(srcs):
        w, _ = load_wav(os.path.join(root, "wavs", "single" if i < 3 else "mix", name), sr=8000)
        save_wav(os.path.join(ref, name), w, 8000)
        g = 0.9 * w[: len(w) - 400 * i] + 0.01 * rs.randn(len(w) - 400 * i)
        save_wav(os.path.join(gen, name.replace(".wav", "_generated.wav")), g.astype(np.float32), 8000)
    save_wav(os.path.join(gen, "unmatched.wav"), (0.1 * rs.randn(8000)).astype(np.float32), 8000)
    tables, walls = {}, {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(root, f"metrics_{dev}.csv")
        t0 = time.time()
        EM.main(["--gen_dir", gen, "--ref_dir", ref, "--out_csv", out, "--device", dev])
        walls[dev] = time.time() - t0
        with open(out) as f:
            lines = f.read().splitlines()
        rows = list(csv.DictReader([ln for ln in lines if not ln.startswith("#")]))
        trailer = [ln for ln in lines if ln.startswith("# ")]
        tables[dev] = (rows, trailer)
    rows, trailer = tables["cuda"]
    values = [float(row[k]) for row in rows for k in EM.COLUMNS]
    diff = max(abs(float(a[k]) - float(b[k])) for a, b in zip(rows, tables["cpu"][0]) for k in EM.COLUMNS)
    ok = (len(rows) == 4 and [r["file"] for r in rows] == [r["file"] for r in tables["cpu"][0]]
          and all(math.isfinite(v) for v in values) and len(trailer) == len(EM.COLUMNS) and diff <= METRICS_CARD_TOL)
    log(f"21 evaluate_metrics --device cuda: {len(rows)} pairs in {walls['cuda']:.2f} s (cpu {walls['cpu']:.2f} s); "
        f"rows {rows}; trailer {trailer}; card vs CPU max |diff| {diff:.3e} (tol {METRICS_CARD_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("evaluate_metrics on the card: rows, trailer or numbers wrong")
    results["data_prep"].update(metrics_rows=len(rows), metrics_card_vs_cpu_max_abs_diff=diff,
                                metrics_cuda_s=walls["cuda"], metrics_cpu_s=walls["cpu"])


def check_legacy_helpers_on_card(results):
    """stft_complex / istft (n_fft 510, hop 128, hann and sqrthann) and
    light_conv / dynamic_conv (causal and centred padding_l) on the card
    against the CPU, f32 with TF32 off; istft(stft(x)) gives x back."""
    import numpy as np
    import torch
    from covomix_tpu_torch.audio import spec as S
    from covomix_tpu_torch.ops import lightconv as LC

    def err(card, cpu):
        card, cpu = card.cpu(), cpu
        return ((card - cpu).abs().max() / max(1.0, cpu.abs().max().item())).item()

    rs = np.random.RandomState(6)
    x = torch.from_numpy((rs.randn(2, 8000 * 20) * 0.3).astype(np.float32))
    errs = {}
    for window in ("hann", "sqrthann"):
        spec_cpu = S.stft_complex(x, 510, 128, window)
        spec = S.stft_complex(x.cuda(), 510, 128, window)
        back = S.istft(spec, 510, 128, window, length=x.shape[1])
        errs[f"stft_{window}"] = err(spec, spec_cpu)
        errs[f"istft_{window}"] = err(back, S.istft(spec_cpu, 510, 128, window, length=x.shape[1]))
        errs[f"round_trip_{window}"] = (back.cpu() - x)[:, 510:-510].abs().max().item()
    h = torch.from_numpy((rs.randn(2, 912, 256)).astype(np.float32))
    w = torch.from_numpy(rs.randn(8, 7).astype(np.float32))
    dw = torch.from_numpy(rs.randn(2, 912, 8, 7).astype(np.float32))
    for pad in (6, 3):
        errs[f"light_conv_pad{pad}"] = err(LC.light_conv(h.cuda(), w.cuda(), padding_l=pad),
                                           LC.light_conv(h, w, padding_l=pad))
        errs[f"dynamic_conv_pad{pad}"] = err(LC.dynamic_conv(h.cuda(), dw.cuda(), padding_l=pad),
                                             LC.dynamic_conv(h, dw, padding_l=pad))
    ok = all(v <= (LIGHTCONV_CARD_TOL if "conv" in k else 1e-4 if k.startswith("round") else SPEC_CARD_TOL)
             for k, v in errs.items())
    log(f"21 spec / lightconv card vs CPU (rel. to max(1, max|cpu|); round trip absolute): "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("stft / istft / light_conv / dynamic_conv on the card disagree with the CPU")
    results["data_prep"]["legacy_card_vs_cpu"] = errs


def eval_models(vomix=None, t2s=None):
    """(VoSingle, VoMix two_one, VoMix two_two, CoMix T2S) full-width
    parameters and configs: VoMix and T2S phase 4's (or built as phase 4
    builds them), the other two seeded."""
    import dataclasses

    import torch
    from covomix_tpu_torch.models import acoustic as A, text2semantic as T

    t2s_cfg, ac_cfg, _ = full_width_configs()
    if vomix is None:
        g = torch.Generator(device="cuda").manual_seed(0)
        t2s, vomix = T.init(g, t2s_cfg), A.init(g, ac_cfg)
    g = torch.Generator(device="cuda").manual_seed(21)
    single_cfg = dataclasses.replace(ac_cfg, dim_in=80, mode="single")   # running_command/Acous_VoSingle.sh
    two_two_cfg = dataclasses.replace(ac_cfg, mode="two_two")
    return ((A.init(g, single_cfg), single_cfg), (vomix, ac_cfg), (A.init(g, two_two_cfg), two_two_cfg),
            (t2s, t2s_cfg))


def run_eval_files(results, models, single, mixed, codes):
    """The four file-level evals at full width, f32 (their default), on
    EVAL_FILES files each, with a CUDA generator, counts set to 0 before
    each and read after: every acoustic file's flow sample launches exactly
    16 steps x 2 evaluations x 8 layers = 256 f32 forwards (one CFG-doubled
    batch per evaluation) and no other flash kernel (no pre-pass: the f32
    kernel applies the rotary itself); two_one skips nothing here (every
    file has its mix); the T2S eval (its decode cut to EVAL_T2S_MAX_LENGTH)
    launches none. Every 'l2' finite and > 0."""
    import torch
    from covomix_tpu_torch.data.tokenizer import load_covomix_tokenizer
    from covomix_tpu_torch.models import acoustic as A
    from covomix_tpu_torch.train import evaluate as E

    (single_p, single_cfg), (mix_p, mix_cfg), (tt_p, tt_cfg), (t2s_p, t2s_cfg) = models
    gen = torch.Generator(device="cuda").manual_seed(21)
    per_file_want = launches(fwd=16 * 2 * mix_cfg.depth)
    out, files = {}, {}
    orig = A.sample

    def counted(*a, **kw):
        c0 = flash_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        y = orig(*a, **kw)
        torch.cuda.synchronize()
        files[name].append({"frames": int(a[4].shape[1]), "valid_len": kw.get("valid_len"),
                            "wall_s": time.time() - t0,
                            "launches": {k: v - c0[k] for k, v in flash_counts().items()}})
        return y

    for name, fn, params, cfg, paths in (("single", E.evaluate_acoustic_files, single_p, single_cfg, single),
                                         ("two_one", E.evaluate_acoustic_two_one_files, mix_p, mix_cfg, mixed),
                                         ("two_two", E.evaluate_acoustic_two_two_files, tt_p, tt_cfg, mixed)):
        files[name] = []
        A.sample = counted
        zero_counts()
        try:
            t0 = time.time()
            m = fn(params, cfg, paths, EVAL_FILES, gen)
            wall = time.time() - t0
        finally:
            A.sample = orig
        counts = flash_counts()
        out[name] = {"l2": m["l2"], "wall_s": wall, "launches": counts["fwd"], "files": files[name]}
        log(f"21 {fn.__name__} ({name}, full width f32, {EVAL_FILES} files): l2 {m['l2']:.6f}, {wall:.2f} s; per file "
            f"(frames, valid_len, s, forwards) {[(f['frames'], f['valid_len'], round(f['wall_s'], 4), f['launches']['fwd']) for f in files[name]]}; "
            f"launches {counts}")
        if len(files[name]) != EVAL_FILES or any(f["launches"] != per_file_want for f in files[name]) \
                or counts != launches(fwd=EVAL_FILES * per_file_want["fwd"]):
            raise AssertionError(f"{name}: flow samples {len(files[name])}, launches per file "
                                 f"{[f['launches'] for f in files[name]]}, expected {per_file_want} each")
        if any(f["frames"] < 512 for f in files[name]):
            raise AssertionError(f"{name}: a file below the flash route's 512 frames")
        if not (math.isfinite(m["l2"]) and m["l2"] > 0):
            raise AssertionError(f"{name}: l2 {m['l2']}")
    tok = load_covomix_tokenizer(None, strict=False)
    zero_counts()
    t0 = time.time()
    m = E.evaluate_t2s_files(t2s_p, t2s_cfg, tok, codes, EVAL_FILES, gen, max_length=EVAL_T2S_MAX_LENGTH)
    wall = time.time() - t0
    counts = flash_counts()
    out["t2s"] = {"l2": m["l2"], "wall_s": wall, "launches": counts["fwd"]}
    log(f"21 evaluate_t2s_files (CoMix T2S, f32, max_length {EVAL_T2S_MAX_LENGTH}, {EVAL_FILES} files): "
        f"WER l2 {m['l2']:.4f}, {wall:.2f} s; launches {counts}")
    if counts != launches() or not (math.isfinite(m["l2"]) and m["l2"] > 0):
        raise AssertionError(f"evaluate_t2s_files: l2 {m['l2']}, launches {counts}")
    results["eval_files"] = out
    return mix_p, mix_cfg


def adaptive_inputs(cfg, b, t, seed):
    import numpy as np
    import torch

    rs = np.random.RandomState(seed)
    shape = (b, t, 2) if cfg.n_phoneme_streams == 2 else (b, t)
    return (torch.from_numpy(rs.randint(0, 500, shape).astype(np.int64)).cuda(),
            torch.from_numpy((rs.randn(b, t, cfg.dim_in) * 0.3).astype(np.float32)).cuda())


def run_adaptive(results, params, cfg):
    """acoustic.sample_adaptive at full width (phase 4's VoMix), bf16,
    ADAPTIVE_SHAPE, cond_scale 0.7, at most ADAPTIVE_MAX_STEPS attempts:
    every attempt 7 stages x 8 layers = 56 bf16 forwards (one CFG-doubled
    batch per stage) and as many rotary pre-passes, nothing else; y finite.
    Then sample_regression in f32 with CFG at the same shape: 2 separate
    forwards x 8 layers = 16 f32 forwards, no pre-pass; finite."""
    import torch
    from covomix_tpu_torch.models import acoustic as A

    b, t = ADAPTIVE_SHAPE
    ph, cond = adaptive_inputs(cfg, b, t, 7)
    gen = torch.Generator(device="cuda").manual_seed(7)
    norms = []
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    y, steps = A.sample_adaptive(params, cfg, gen, ph, cond, cond_scale=0.7, max_steps=ADAPTIVE_MAX_STEPS,
                                 dtype=torch.bfloat16, norms=norms)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = flash_counts()
    per_attempt = 7 * cfg.depth
    accepted = sum(n <= 1.0 for n in norms)
    log(f"21 sample_adaptive bf16 B={b} T={t} cond_scale 0.7: {steps} attempts ({accepted} accepted), "
        f"{wall:.3f} s ({wall / steps * 1e3:.2f} ms per attempt); error norms {[round(n, 4) for n in norms]}; "
        f"launches {counts}")
    if counts != launches(fwd=per_attempt * steps, rotary=per_attempt * steps) or not 0 < steps <= ADAPTIVE_MAX_STEPS:
        raise AssertionError(f"sample_adaptive: {steps} attempts, launches {counts}, expected {per_attempt} forwards "
                             f"and pre-passes per attempt")
    if tuple(y.shape) != (b, t, cfg.mel_dim) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"sample_adaptive: y {tuple(y.shape)}, finite {bool(torch.isfinite(y).all())}")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    r = A.sample_regression(params, cfg, gen, ph, cond, cond_scale=0.7)
    torch.cuda.synchronize()
    reg_wall = time.time() - t0
    reg_counts = flash_counts()
    log(f"21 sample_regression f32 B={b} T={t} cond_scale 0.7: {reg_wall:.3f} s; launches {reg_counts}")
    if reg_counts != launches(fwd=2 * cfg.depth) or not bool(torch.isfinite(r).all()):
        raise AssertionError(f"sample_regression: launches {reg_counts}, finite {bool(torch.isfinite(r).all())}")
    results["adaptive"] = {"attempts": steps, "accepted": accepted, "wall_s": wall, "launches": counts["fwd"],
                           "rotary_launches": counts["rotary"], "regression_wall_s": reg_wall,
                           "regression_launches": reg_counts["fwd"]}


def check_small_adaptive_against_cpu(results):
    """sample_adaptive of a small f32 model (dim 128, 2 layers, dh 64, T=512:
    the flash kernel on the card, layers.attend on the CPU), cond_scale 0.7,
    the same weights and y0, TF32 off: the same number of attempts, y within
    ADAPTIVE_CPU_TOL x max |y|. Where the counts differ, both runs' error
    norms at the first attempt where they part are logged before failing."""
    import numpy as np
    import torch
    from covomix_tpu_torch.models import acoustic as A
    from covomix_tpu_torch.util.misc import tree_map

    cfg = A.AcousticConfig(dim_in=80, dim=128, depth=2, heads=2, dim_head=64, dim_phoneme_emb=64)
    params = A.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    ph, cond = (v.cpu() for v in adaptive_inputs(cfg, 1, 512, 8))
    y0 = torch.randn((1, 512, 80), generator=torch.Generator().manual_seed(4))
    runs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda v: v.to(dev), params)
        norms = []
        zero_counts()
        y, steps = A.sample_adaptive(p, cfg, None, ph.to(dev), cond.to(dev), cond_scale=0.7, noise=y0.to(dev),
                                     norms=norms)
        runs[dev] = (y.cpu(), steps, norms, flash_counts())
    (yc, sc, nc, _), (yg, sg, ng, counts) = runs["cpu"], runs["cuda"]
    if sc != sg:
        part = next(i for i, (a, b) in enumerate(zip(nc, ng)) if (a <= 1.0) != (b <= 1.0))
        log(f"21 small sample_adaptive card vs CPU: attempts {sg} vs {sc}; the runs part at attempt {part}: "
            f"error norm card {ng[part]!r}, CPU {nc[part]!r} FAIL")
        raise AssertionError("sample_adaptive takes another number of attempts on the card than on the CPU")
    err = ((yg - yc).abs().max() / yc.abs().max()).item()
    norm_diff = max(abs(a - b) / max(b, 1e-30) for a, b in zip(ng, nc))
    ok = err <= ADAPTIVE_CPU_TOL and counts == launches(fwd=7 * cfg.depth * sg)
    log(f"21 small sample_adaptive f32 card vs CPU: {sg} attempts both, y max |diff| / max |y| {err:.3e} "
        f"(tol {ADAPTIVE_CPU_TOL:g}), error norms max rel. diff {norm_diff:.3e}; card launches {counts} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("small sample_adaptive: card and CPU disagree")
    results["adaptive"].update(small_attempts=sg, small_card_vs_cpu=err)


def run_phase21(results, root, models=None, data_prep=True, evals=True):
    """Phase 21 under `root` (removed after): the data and its checks, then
    (with `evals`) the file-level evals, sample_adaptive / sample_regression
    and the small adaptive run card vs CPU; (with `data_prep`)
    evaluate_metrics and the legacy helpers card vs CPU. `models`: from
    eval_models, built there when not given."""
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.time()
    try:
        single, mixed, codes = prepare_eval_data(results, root)
        if data_prep:
            run_eval_metrics(results, root)
            check_legacy_helpers_on_card(results)
        if evals:
            mix_p, mix_cfg = run_eval_files(results, models or eval_models(), single, mixed, codes)
            run_adaptive(results, mix_p, mix_cfg)
            check_small_adaptive_against_cpu(results)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    results["phase21_s"] = time.time() - t_phase
    log(f"phase 21 wall {results['phase21_s']:.1f} s")


def phase21_mode(which: str) -> int:
    """`python3 chip_smoke.py --data_prep` / `--eval_files`: phase 21's data
    preparation (prepare_mels, evaluate_metrics, the legacy helpers) or its
    file-level evals and adaptive sampling (on models built as phase 4
    builds them) alone, ending with the same `ok` line. The kernels build on
    first use."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from covomix_tpu_torch.ops import vocoder_tail as VT

    t_start = time.time()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    run_phase21(results, os.path.join(VT.BUILD_DIR, "smoke_eval"), data_prep=which == "data_prep",
                evals=which == "eval_files")
    log(f"total chip_smoke --{which} time {time.time() - t_start:.1f} s")
    log("data preparation and file-level evals: " + json.dumps({k: results[k] for k in
                                                              ("data_prep", "eval_files", "adaptive") if k in results}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 22: K optimizer steps per dispatch, one captured CUDA graph (--steps_per_dispatch)


MULTI_K = 4
# name -> (model, dtype, timed): the recipes' shapes at full width; the f32 VoMix cell (the recipes' own
# precision) is held and its kernels counted, not timed
MULTI_CELLS = {"vomix_bf16": ("vomix", "bf16", True), "t2s_bf16": ("t2s", "bf16", True),
               "vomix_f32": ("vomix", "f32", False)}
MULTI_DISPATCHES = 3     # timed dispatches of each form, in turns, each ended by a synchronize
# the flash kernels of one step of a cell: (kernel name in a trace, flash_counts key, launches a step)
MULTI_KERNELS = {
    "vomix_bf16": (("flash_fwd_wgmma", "fwd_lse", 8), ("flash_bwd_dq_wgmma", "bwd_dq", 8),
                   ("flash_bwd_dkv_wgmma", "bwd_dkv", 8), ("flash_rotary_halfsplit_bf16", "rotary", 8)),
    "t2s_bf16": (("flash_fwd_wgmma", "fwd_lse_causal", 4), ("flash_bwd_dq_wgmma", "bwd_dq_causal", 4),
                 ("flash_bwd_dkv_wgmma", "bwd_dkv_causal", 4)),
    "vomix_f32": (("flash_fwd_f32_tile", "fwd_lse", 8), ("flash_bwd_dq_f32_tile", "bwd_dq", 8),
                  ("flash_bwd_dkv_f32_tile", "bwd_dkv", 8)),
}


def multi_cell(model, dt):
    """(parameters, loss_fn, train config, [MULTI_K, ...] numpy batch) of a
    phase-22 cell, seeded: the VoMix recipe's model and batch (B=8, T=832,
    one random span mask a row, cond-drop 0.3: the loss draws noise, times
    and the drop coin) or the CoMix T2S recipe's (B=6, 64 text ids, targets
    bucketed to 1024: decoder T 1026, the causal flash route). The schedule
    moves the learning rate inside the dispatch (2 steps an epoch) and the
    clip is on."""
    import numpy as np
    import torch
    from covomix_tpu_torch.models import acoustic as A, text2semantic as T
    from covomix_tpu_torch.train import loop

    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    rs, gen, k = np.random.RandomState(22), torch.Generator(device="cuda").manual_seed(22), MULTI_K
    tcfg = loop.TrainConfig(lr=1e-4, use_lr_schedule=True, steps_per_epoch=2, wake_up_epochs=15, grad_clip=1.0)
    if model == "vomix":
        cfg = A.AcousticConfig(dim_in=160, dim=1024, depth=8, heads=16, dim_head=64, num_phoneme_tokens=502,
                               mode="two_one")
        start = rs.randint(0, 400, (k, 8))
        mask = (np.arange(832) >= start[..., None]) & (np.arange(832) < start[..., None] + 300)
        batch = {"x": (rs.randn(k, 8, 832, 240) * 2 - 5).astype(np.float32),
                 "phonemes": rs.randint(0, 502, (k, 8, 832, 2)).astype(np.int32), "mask": mask}
        return A.init(gen, cfg), loop.acoustic_loss_fn(cfg, cond_drop_prob=0.3, dtype=dtype), tcfg, batch
    cfg = T.T2SConfig(dim=512, source_depth=4, target_depth=4, heads=8, dim_head=64, num_text_tokens=30528,
                      num_semantic_tokens=501, target_dim=1024, two_output=True)
    batch = {"text_ids": rs.randint(1, 180, (k, 6, 64)).astype(np.int32),
             "semantic_ids": rs.randint(0, 500, (k, 6, 1024, 2)).astype(np.int32)}
    return T.init(gen, cfg), loop.t2s_loss_fn(cfg, dtype=dtype), tcfg, batch


def differences(got: dict, ref: dict) -> dict:
    """{name: max |got - ref|} of the tensors of `got` that are not equal to
    `ref`'s bit for bit."""
    import torch

    if got.keys() != ref.keys():
        return {"keys": sorted(set(got) ^ set(ref))}
    return {k: (got[k].double() - ref[k].double()).abs().max().item() for k in got
            if not torch.equal(got[k], ref[k])}


def run_multi_cell(name) -> dict:
    """One phase-22 cell: from one state and generator, MULTI_K eager
    `make_train_step` calls against one `make_multi_step` dispatch (its
    capture and first replay) on the same stacked batch: parameters, EMA,
    Adam's moments and counts, the K losses and grad norms and the
    generator's next draw bit for bit. The warm-up before the capture must
    launch one step's flash kernels and the capture record K steps' (the
    launches of one replay); one more replay, traced, must show the
    hand-written kernels at their per-step counts x K (where the trace
    attributes the graph's kernels). Timed cells: ms a step of the eager
    steps and of the captured dispatch over MULTI_DISPATCHES dispatches each
    (in turns), one eager dispatch traced for its idle share beside the
    replay's; the capture's seconds, the graph's pool and the peak GiB."""
    import torch
    from covomix_tpu_torch.train import loop

    model, dt, timed = MULTI_CELLS[name]
    t_cell = time.time()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, loss_fn, tcfg, batch = multi_cell(model, dt)
    state = loop.init_train_state(params, tcfg)
    eager, multi = loop.make_train_step(loss_fn, tcfg), loop.make_multi_step(loss_fn, tcfg, MULTI_K)
    gen = torch.Generator(device="cuda").manual_seed(23)

    def eager_dispatch():
        return [eager(state, {k: v[i] for k, v in batch.items()}, gen) for i in range(MULTI_K)]

    eager_dispatch()        # Adam's moments live and every kernel built before the reference
    torch.cuda.synchronize()
    # detached: a clone of a parameter that records autograd would keep its grad accumulator alive, made on
    # this (the legacy) stream, and the capture's backward would then have to join that stream
    saved = {k: v.detach().clone() for k, v in loop.state_tensors(state).items()}
    counters, g0 = (state.step, state.ema_num_updates), gen.get_state()
    ms = eager_dispatch()
    ref_metrics = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
    ref_draw = torch.rand(256, generator=gen, device="cuda")
    ref = {k: v.detach().clone() for k, v in loop.state_tensors(state).items()}
    with torch.no_grad():   # back to the saved state, in place
        for k, v in loop.state_tensors(state).items():
            v.copy_(saved[k])
    del saved
    state.step, state.ema_num_updates = counters
    gen.set_state(g0)
    torch.cuda.empty_cache()
    c0, reserved0 = flash_counts(), torch.cuda.memory_reserved()
    metrics = multi(state, batch, gen)
    torch.cuda.synchronize()
    warm = {k: v - c0[k] for k, v in flash_counts().items()}
    entry = multi.last
    torch.cuda.empty_cache()    # what stays reserved is the graph's private pool (and the metrics)
    pool_gib = (torch.cuda.memory_reserved() - reserved0) / 2 ** 30
    diff = differences(loop.state_tensors(state), ref)
    diff.update({f"metric_{k}": v for k, v in differences(metrics, ref_metrics).items()})
    diff.update({"generator_next_draw": v for v in differences({"d": torch.rand(256, generator=gen,
                                                                                 device="cuda")},
                                                                {"d": ref_draw}).values()})
    del ref
    per_step = launches(**{key: n for _, key, n in MULTI_KERNELS[name]})
    recorded = {key: entry.launches.get(attr, 0) for key, attr in COUNTS.items()}
    rec = {"k": MULTI_K, "launches_per_step": per_step, "launches_per_dispatch": recorded,
           "warmup_launches": warm, "capture_s": entry.capture_s, "pool_gib": pool_gib,
           "state_counters": [state.step, state.ema_num_updates], "losses": metrics["loss"].tolist(),
           "grad_norms": metrics["grad_norm"].tolist(), "differences": diff}
    log(f"multi-step {name}: captured dispatch vs {MULTI_K} eager steps: {json.dumps(rec)}")
    if diff:
        raise AssertionError(f"multi-step {name}: the captured dispatch differs from {MULTI_K} eager steps: {diff}")
    if recorded != {k: v * MULTI_K for k, v in per_step.items()} or warm != per_step:
        raise AssertionError(f"multi-step {name}: launches {recorded} a dispatch (warm-up {warm}), expected "
                             f"{per_step} a step")
    replay_idle, by_kernel = traced_idle_share(f"multi-step {name}, one captured dispatch",
                                               lambda: multi(state, batch, gen), by_kernel=True)
    traced = {base: sum(n for nm, (n, _) in by_kernel.items() if base in nm) for base, _, _ in MULTI_KERNELS[name]}
    want = {base: n * MULTI_K for base, _, n in MULTI_KERNELS[name]}
    rec.update(traced_launches=traced, replay_idle=replay_idle,
               trace_top=[[nm[:90], n, ms] for nm, (n, ms) in list(by_kernel.items())[:8]])
    if not any(traced.values()):
        log(f"multi-step {name}: the trace attributes none of the graph's flash kernels; gated on the launches "
            f"recorded at the capture")
    elif traced != want:
        raise AssertionError(f"multi-step {name}: the traced replay ran {traced}, expected {want}")
    if multi.captures != 1 or multi.replays != 2:
        raise AssertionError(f"multi-step {name}: {multi.captures} captures, {multi.replays} replays")
    if timed:
        walls = {"eager": [], "captured": []}
        for _ in range(MULTI_DISPATCHES):
            for form, fn in (("captured", lambda: multi(state, batch, gen)), ("eager", eager_dispatch)):
                torch.cuda.synchronize()
                t0 = time.time()
                fn()
                torch.cuda.synchronize()
                walls[form].append((time.time() - t0) * 1e3 / MULTI_K)
        eager_idle = traced_idle_share(f"multi-step {name}, {MULTI_K} eager steps", eager_dispatch)
        rec.update(ms_per_step={form: statistics.median(v) for form, v in walls.items()}, ms_per_step_all=walls,
                   eager_idle=eager_idle)
    if model == "t2s":      # the cache full: one graph per decoder bucket up to GRAPH_CACHE_SIZE shapes
        rec["cache_fill"] = fill_graph_cache(multi, state, batch, gen)
    rec.update(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, wall_s=time.time() - t_cell)
    log(f"multi-step {name}: " + json.dumps({k: rec[k] for k in ("ms_per_step", "capture_s", "pool_gib", "peak_gib",
                                                                 "traced_launches", "wall_s") if k in rec}))
    del multi, eager, state, params
    return rec


MULTI_CLI_DEPTH = 2    # the CLI runs' depth: a depth-8 state.npz (4 GB) took ~6 s a save; the cells hold depth 8


def train_state_checksums(state) -> dict:
    """{name: bits_checksum} of every tensor a step writes (on the card),
    and the counters."""
    from covomix_tpu_torch.train import loop

    out = {k: tuple(bits_checksum(v.detach().float().reshape(-1)).tolist())
           for k, v in loop.state_tensors(state).items()}
    return {**out, "counters": (state.step, state.ema_num_updates)}


def fill_graph_cache(multi, state, batch, gen) -> dict:
    """One dispatch at each of the T2S recipe's longer decoder buckets
    (targets 1280, 1536, ...: decoder T up to 1794) until the multi-step's
    cache holds GRAPH_CACHE_SIZE graphs: each a capture of its own, every
    graph kept; the card's reserved memory (the graphs' pools) and peak."""
    import numpy as np
    import torch
    from covomix_tpu_torch.train import loop

    rs, shapes = np.random.RandomState(24), []
    for n in range(loop.GRAPH_CACHE_SIZE - len(multi.graphs)):
        t = 1024 + 256 * (n + 1)
        multi(state, {"text_ids": batch["text_ids"], "semantic_ids": rs.randint(0, 500, (MULTI_K, 6, t, 2)).astype(
            np.int32)}, gen)
        shapes.append(t + 2)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {"decoder_t": shapes, "graphs": len(multi.graphs), "captures": multi.captures,
           "capture_s": multi.last.capture_s, "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"multi-step t2s, the graph cache full: {json.dumps(out)}")
    if out["graphs"] != loop.GRAPH_CACHE_SIZE:
        raise AssertionError(f"the multi-step cache holds {out['graphs']} graphs, expected {loop.GRAPH_CACHE_SIZE}")
    return out


def run_multi_cli(results, root):
    """`covomix_tpu_torch.train.cli.main` on the VoMix recipe at full width
    (bf16, B=8, T=832; depth cut to MULTI_CLI_DEPTH) on 24 random items with
    `--steps_per_dispatch 4 --max_steps 8 --ckpt_every 4 --eval_every 0`,
    then `--resume` to 12 (saves at 4, 8 and 12); beside it, from the
    dispatched run's step 8 as written, the same resume with one step a
    dispatch (eager). The two resumed runs must save the same state at 12,
    bit for bit (checksums of every saved tensor's bits; both resume with
    a fresh loader and generator, as JAX's train.py does). Every dispatched
    run captures once (its warm-up launching one step's flash kernels) and
    replays its dispatches, each running 4 steps' kernels; the eager resume
    launches them step by step."""
    from covomix_tpu_torch.checkpoint import io as cio
    from covomix_tpu_torch.train import cli, loop

    train_dir, logs = os.path.join(root, "train"), os.path.join(root, "logs")
    write_vomix_items(train_dir, 24, 0)
    argv = ["--base_dir", train_dir, *VOMIX_RECIPE, "--CoVoMix_depth", str(MULTI_CLI_DEPTH), "--device", "cuda",
            "--log_every", "4", "--eval_every", "0", "--ckpt_every", "4", "--no_wandb", "--log_dir", logs,
            "--seed", "0"]
    made, saves, orig = [], {}, (loop.make_multi_step, cio.save_train_state)

    def make_multi_step(loss_fn, cfg, k):
        made.append(orig[0](loss_fn, cfg, k))
        return made[-1]

    def save_train_state(ckpt_dir, state, step):
        orig[1](ckpt_dir, state, step)
        saves[(os.path.basename(os.path.dirname(ckpt_dir)), step)] = train_state_checksums(state)

    per_step = launches(fwd_lse=MULTI_CLI_DEPTH, bwd_dq=MULTI_CLI_DEPTH, bwd_dkv=MULTI_CLI_DEPTH,
                        rotary=MULTI_CLI_DEPTH)
    runs = (("k4", ["--steps_per_dispatch", "4", "--max_steps", "8"]),
            ("k4", ["--steps_per_dispatch", "4", "--max_steps", "12", "--resume"]),
            ("k1r", ["--max_steps", "12", "--resume"]))
    loop.make_multi_step, cio.save_train_state = make_multi_step, save_train_state
    out = {}
    try:
        for i, (run, extra) in enumerate(runs):
            zero_counts()
            t0 = time.time()
            cli.main(argv + ["--run_name", run] + extra)
            step = made[-1]
            if i == 0:      # the eager resume's start: this run's step 8 as written (a hard link; the
                step8 = os.path.join(logs, "k1r", "checkpoints", "step_00000008")   # resume at 12 prunes it)
                os.makedirs(step8)
                os.link(os.path.join(logs, "k4", "checkpoints", "step_00000008", "state.npz"),
                        os.path.join(step8, "state.npz"))
            out[f"run{i + 1}_{run}"] = {"s": time.time() - t0, "eager_launches": flash_counts(),
                                        **({"captures": step.captures, "replays": step.replays,
                                            "replayed": {k: step.replayed.get(a, 0) for k, a in COUNTS.items()}}
                                           if isinstance(step, loop.MultiStep) else {})}
    finally:
        loop.make_multi_step, cio.save_train_state = orig
    log(f"multi-step CLI runs: saves {sorted(saves)}; {json.dumps(out)}")
    if sorted(saves) != [("k1r", 12), ("k4", 4), ("k4", 8), ("k4", 12)]:
        raise AssertionError(f"multi-step CLI saves {sorted(saves)}, expected k4 at 4, 8, 12 and k1r at 12")
    times = lambda n: {k: v * n for k, v in per_step.items()}
    for key, dispatches in (("run1_k4", 2), ("run2_k4", 1)):
        r = out[key]
        if (r["captures"], r["replays"], r["replayed"], r["eager_launches"]) != (1, dispatches,
                                                                                 times(4 * dispatches), per_step):
            raise AssertionError(f"multi-step CLI {key}: {r}, expected one capture (a step's warm-up launches) "
                                 f"and {dispatches} replays of 4 steps' launches")
    if out["run3_k1r"]["eager_launches"] != times(4):
        raise AssertionError(f"multi-step CLI eager resume launched {out['run3_k1r']}")
    got, ref = saves[("k4", 12)], saves[("k1r", 12)]
    bad = sorted(k for k in ref if got.get(k) != ref[k])
    if bad or got.keys() != ref.keys():
        raise AssertionError(f"multi-step CLI: the dispatched resume's step 12 differs from the eager one's: {bad[:8]}")
    results["multi_cli"] = out


def run_multi_step(results, root):
    """Phase 22: every MULTI_CELLS cell, then the CLI runs (run_multi_cli)
    under `root` (removed after)."""
    t0 = time.time()
    cells = {name: run_multi_cell(name) for name in MULTI_CELLS}
    shutil.rmtree(root, ignore_errors=True)
    try:
        run_multi_cli(results, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    results.update(multi_step=cells, multi_step_wall_s=time.time() - t0)
    log(f"phase 22 wall {results['multi_step_wall_s']:.1f} s")


def multi_step_mode() -> int:
    """`python3 chip_smoke.py --multi_step`: phase 22 alone, ending with the
    same `ok` line. The kernels build on first use."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from covomix_tpu_torch.ops import vocoder_tail as VT

    t_start = time.time()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    run_multi_step(results, os.path.join(VT.BUILD_DIR, "smoke_multi"))
    log(f"total chip_smoke --multi_step time {time.time() - t_start:.1f} s")
    log("multi-step training: " + json.dumps({"cells": results["multi_step"], "cli": results["multi_cli"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 23: the CoVoSingle family at full width (the CoSingle T2S and VoSingle acoustic models)


# the CoSingle T2S recipe (running_command/T2S_CoSingle.sh, the fallback vocab in place of --bert_vocab) and
# the VoSingle acoustic recipe (Acous_VoSingle.sh) on one card, bf16; f32 as the recipes are written
COSINGLE_T2S_RECIPE = ["--format", "text2semantic", "--text2semantic", "--allow_fallback_vocab",
                       "--CoVoMix_dim_transformer", "512", "--text2semantic_tokens", "501",
                       "--text2semantic_source_depth", "4", "--text2semantic_target_depth", "4",
                       "--text2semantic_head", "8", "--batch_size", "10", "--lr", "1e-4", "--lr_scheduler", "--bf16"]
VOSINGLE_RECIPE = ["--format", "hubert_fisher", "--CoVoMix_dim", "80", "--CoVoMix_dim_transformer", "1024",
                   "--CoVoMix_depth", "8", "--CoVoMix_heads", "16", "--CoVoMix_num_phoneme_tokens", "502",
                   "--cond_drop_prob", "0.3", "--batch_size", "6", "--lr", "1e-4", "--lr_scheduler", "--bf16"]
# recipe -> (flags, batch, train items, evaluate function, a bf16 step's flash launches)
SINGLE_RECIPES = {
    "vosingle": (VOSINGLE_RECIPE, 6, 12, "evaluate_acoustic", launches(fwd_lse=8, bwd_dq=8, bwd_dkv=8, rotary=8)),
    "cosingle": (COSINGLE_T2S_RECIPE, 10, 20, "evaluate_t2s",
                 launches(fwd_lse_causal=4, bwd_dq_causal=4, bwd_dkv_causal=4)),
}
SINGLE_TRAIN_STEPS = 4    # bf16 steps of each recipe, the eval and its top-k save at the last, then a resumed one
SINGLE_F32_STEPS = 3      # f32 steps of each recipe: no eval, no resume
# (CLI, mode, --fuse_tail) of the generation runs, in this order on phase 6's asset directory, and the
# (T2S, acoustic) checkpoints each mode pairs
SINGLE_RUNS = (("monologue", "covosingle", True), ("monologue", "covosinx", False), ("monologue", "covomix", True),
               ("dialogue", "covosingle", True), ("dialogue", "covosinx", False))
SINGLE_MODELS = {"covosingle": ("t2s_single.npz", "acoustic_single.npz"),
                 "covosinx": ("t2s_single.npz", "acoustic.npz"), "covomix": ("t2s.npz", "acoustic.npz")}
MONOLOGUE_SCRIPT = "hello there, how are you doing today? i am fine, thank you [laughter] see you soon"
SINGLE_HELD = 256        # the one-stream captured decode held against the direct step on this prefix


def single_family_configs():
    """(CoSingle T2SConfig, VoSingle AcousticConfig) at full width: what
    T2S_CoSingle.sh and train/cli.py build (one output stream, target dim =
    dim = 512) and Acous_VoSingle.sh's model (80-d input, one phoneme
    stream)."""
    import dataclasses

    t2s, ac, _ = full_width_configs()
    return (dataclasses.replace(t2s, target_dim=512, two_output=False),
            dataclasses.replace(ac, dim_in=80, mode="single"))


def write_single_assets(root, seed=23):
    """In phase 6's asset directory `root`: seeded full-width CoSingle and
    VoSingle checkpoints beside phase 6's CoMix, VoMix and vocoder ones, the
    monologue script with a prompt (phase 6's first speaker's, copied), and
    DIALOGUE_SCRIPT alone for the dialogues (on phase 6's prompts)."""
    import dataclasses

    import torch
    from covomix_tpu_torch.checkpoint.io import save_params
    from covomix_tpu_torch.models import acoustic as A, text2semantic as T

    g = torch.Generator(device="cuda").manual_seed(seed)
    for name, init, cfg in zip(("t2s_single", "acoustic_single"), (T.init, A.init), single_family_configs()):
        save_params(os.path.join(root, f"{name}.npz"), init(g, cfg), meta={"config": dataclasses.asdict(cfg)})
    for d in ("mono_texts", "mono_prompts", "single_texts"):
        os.makedirs(os.path.join(root, d))
    with open(os.path.join(root, "mono_texts", "mono0.txt"), "w") as f:
        f.write(MONOLOGUE_SCRIPT)
    for ext in (".hubert_code.npy", ".wav"):
        shutil.copy(os.path.join(root, "prompts", "dlg0_1" + ext), os.path.join(root, "mono_prompts", "mono0" + ext))
    with open(os.path.join(root, "single_texts", "dlg0.txt"), "w") as f:
        f.write(DIALOGUE_SCRIPT)


@contextlib.contextmanager
def recorded_captures():
    """Yields a list that gets, per T2S decode captured while entered, its
    source shape (the text bucket), whether its token streams alias (one
    stream), the capture's seconds and what the card keeps reserved for its
    graph (the private pool: the allocator's cache emptied before and after,
    as phase 22 reads it; GiB)."""
    import torch
    from covomix_tpu_torch.models import text2semantic as T

    orig = T._Decode.capture
    got = []

    def capture(self):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        orig(self)
        torch.cuda.empty_cache()
        got.append({"source": list(self.inputs["mask"].shape), "max_length": self.state["tokens1"].shape[1],
                    "one_stream": self.state["tokens2"] is self.state["tokens1"], "capture_s": self.capture_s,
                    "pool_gib": (torch.cuda.memory_reserved() - reserved) / 2 ** 30})

    T._Decode.capture = capture
    try:
        yield got
    finally:
        T._Decode.capture = orig


def run_single_generation(results, root):
    """Phase 23's generation on phase 6's assets in `root`: the monologue CLI
    in covosingle, covosinx and covomix, the dialogue CLI in covosingle and
    covosinx (SINGLE_RUNS; run_generation_cli's gates), each run's captured
    decodes (text bucket, capture s, pool GiB), the graphs kept; the
    one-stream captured decode against the direct step on its first
    SINGLE_HELD steps, and timed over the whole decode; the flash forward
    held and timed at the covosinx dialogue's flow shape, the fused stage
    and tail at the covosingle dialogue's last vocode's inputs; small f32
    covosingle / covosinx dialogues card vs CPU. Phase 14's decodes are
    dropped first, and this phase's after it."""
    import torch
    from covomix_tpu_torch import pipeline as P
    from covomix_tpu_torch.models import text2semantic as T
    from covomix_tpu_torch.util.misc import round_up

    t0 = time.time()
    T._GRAPHS.clear()
    torch.cuda.empty_cache()
    write_single_assets(root)
    log(f"23 CoSingle / VoSingle checkpoints and scripts written in {time.time() - t0:.1f} s")
    runs = {}
    with recorded_captures() as captures:
        for cli, mode, fuse_tail in SINGLE_RUNS:
            key = f"single_{cli}_{mode}"
            t2s, acoustic = SINGLE_MODELS[mode]
            texts, prompts = ("mono_texts", "mono_prompts") if cli == "monologue" else ("single_texts", "prompts")
            n0 = len(captures)
            decodes = run_generation_cli(results, root, cli, mode, t2s=t2s, acoustic=acoustic, fuse_tail=fuse_tail,
                                         texts=texts, prompts=prompts, key=key)
            inputs = results.pop(f"{key}_vocoder_inputs")
            if (cli, mode) == ("dialogue", "covosingle"):
                vocoder_inputs, (synth, _) = inputs, decodes[0]
            runs[key] = {k: results[f"{key}_{k}"] for k in ("wall_s", "audio_s", "rtf", "decode_steps", "flow_frames",
                                                           "stages", "launches")}
            runs[key]["captures"] = captures[n0:]
        # the one-stream decode of the covosingle dialogue's first turn, as its Synthesizer ran it
        ids = torch.as_tensor(synth._encode_bucketed(P.clean_text(DIALOGUE_SCRIPT.split("[spkchange]")[0])),
                              dtype=torch.int32, device="cuda")

        def decode(gen):
            return T.generate(synth.t2s_params, synth.t2s_cfg, gen, ids, max_length=synth.t2s_max_length,
                              temperature=synth.temperature, cond_scale=synth.t2s_cond_scale, dtype=synth.dtype)

        what = f"one-stream decode B=1 bf16, first {SINGLE_HELD} of {synth.t2s_max_length} steps"
        with stop_after(SINGLE_HELD):
            forms = decode_forms(what, decode, seed=23)
            ties = hold_forms(what, forms, exact=False, streams=1,
                              redo=lambda: decode(torch.Generator(device="cuda").manual_seed(23)))
        steps = forms["graph"]["res"].num_steps
        if steps != SINGLE_HELD:
            raise AssertionError(f"{what}: {steps} steps")
        torch.cuda.synchronize()
        t1 = time.time()
        res = decode(torch.Generator(device="cuda").manual_seed(23))
        torch.cuda.synchronize()
        full_s = time.time() - t1
    held = {"steps": steps, "ties": ties, **per_step_ms(forms, steps),
            "graph_full": {"steps": res.num_steps, "s": full_s, "ms_per_step": full_s / res.num_steps * 1e3}}
    graphs = {"kept": len(T._GRAPHS), "captured": len(captures),
              "pool_gib": sum(c["pool_gib"] for c in captures), "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30,
              "one_stream": sum(c["one_stream"] for c in captures)}
    log(f"23 captured decodes per run (text bucket, capture s, pool GiB): "
        + json.dumps({k: r["captures"] for k, r in runs.items()}))
    log(f"23 one-stream captured decode: {json.dumps(held)}; graphs {json.dumps(graphs)}")
    if graphs["one_stream"] < 1:
        raise AssertionError("23: no one-stream decode was captured")
    frames = results["single_dialogue_covosinx_flow_frames"]   # three turns' tokens after the 400-frame prompt
    time_flash(results, "single_flash", 2, round_up(frames, 128), frames)
    for kind, (x, up, blocks, post) in vocoder_inputs.items():
        time_vocoder(results, f"single_{kind}", kind, x, up, blocks, post)    # a covosingle turn's vocode
    small = {mode: check_small_synth_against_cpu(os.path.join(root, "prompts"), mode) for mode in PER_TURN_MODES}
    T._GRAPHS.clear()
    torch.cuda.empty_cache()
    results["single_generation"] = {"runs": runs, "decode": held, "graphs": graphs, "small_wav_err": small,
                                    "wall_s": time.time() - t0}
    log(f"23 generation wall {time.time() - t0:.1f} s")


def write_vosingle_items(root, n, seed):
    """n random VoSingle items in the hubert_fisher layout: u.mel.npy
    [80, ~1000] f32 and u.hubert_code.npy as a string array."""
    import numpy as np

    rs = np.random.RandomState(seed)
    os.makedirs(root)
    for i in range(n):
        t = 960 + 7 * i
        base = os.path.join(root, f"u{i}")
        np.save(base + ".mel.npy", (rs.randn(80, t) * 2 - 5).astype(np.float32))
        np.save(base + ".hubert_code.npy", rs.randint(0, 500, t).astype(str))


def single_batch(recipe, train_dir):
    """A batch of the recipe's size from its first train items, as the CLI's
    loader collates them."""
    from covomix_tpu_torch.data import datasets as D
    from covomix_tpu_torch.data.tokenizer import load_covomix_tokenizer

    b = SINGLE_RECIPES[recipe][1]
    if recipe == "vosingle":
        ds = D.CoVoMixDataset(train_dir, format="hubert_fisher")
        return D.collate_acoustic([ds[i] for i in range(b)])
    ds = D.CoVoMixDataset(train_dir, format="text2semantic")
    return D.collate_t2s([ds[i] for i in range(b)], load_covomix_tokenizer(None, strict=False))


def run_single_training(results, root):
    """Phase 23's training under `root`: each SINGLE_RECIPES recipe through
    `covomix_tpu_torch.train.cli.main` at full width on random items (VoSingle:
    12 + 6, B=6, bucketed to T=832; CoSingle: 20 + 10 of 520-1000 codes, B=10,
    decoder T 578-1026), bf16 for SINGLE_TRAIN_STEPS steps with one eval and
    its top-k save, then --resume for one step (check_train_run), then f32 for
    SINGLE_F32_STEPS steps (check_steps); every step exactly the recipe's
    flash launches (VoSingle 8 lse forwards, dQ, dK/dV and, in bf16, 8 rotary
    pre-passes; CoSingle 4 causal of each), VoSingle's eval 256 forwards
    without lse and pre-passes per eval batch, CoSingle's eval none; then
    the bf16 step's split and one traced step's idle share, the three
    training kernels held against their plain versions at the recipe's
    shape (bf16 and f32), and two tiny f32 steps of each card vs CPU."""
    import torch
    from covomix_tpu_torch.models import acoustic as A, text2semantic as T
    from covomix_tpu_torch.train import loop

    t0 = time.time()
    cfgs = dict(zip(("cosingle", "vosingle"), single_family_configs()))
    out = {}
    for recipe, (flags, b, n_train, evaluate_name, per_step) in SINGLE_RECIPES.items():
        train_dir, dev_dir, logs = (os.path.join(root, recipe, d) for d in ("train", "dev", "logs"))
        if recipe == "vosingle":
            write_vosingle_items(train_dir, n_train, 0)
            write_vosingle_items(dev_dir, b, 1)
        else:
            write_t2s_items(train_dir, n_train, 0, pairs=False)
            write_t2s_items(dev_dir, b, 1, pairs=False)
        common = ["--base_dir", train_dir, "--device", "cuda", "--log_every", "1", "--ckpt_every", "1000",
                  "--no_wandb", "--log_dir", logs, "--seed", "0"]
        steps, evals, totals, peak_gb, first_s, resume_s = run_train_cli(
            [*common, *flags, "--dev_base_dir", dev_dir, "--eval_every", str(SINGLE_TRAIN_STEPS),
             "--num_eval_files", str(b), "--run_name", f"{recipe}_bf16"], evaluate_name, SINGLE_TRAIN_STEPS)
        batches = evals[0]["batches"] if evals else 0
        eval_launches = launches(fwd=256 * batches, rotary=256 * batches) if recipe == "vosingle" else launches()
        median = check_train_run(f"23 {recipe} bf16", steps, evals, os.path.join(logs, f"{recipe}_bf16", "checkpoints"),
                                 SINGLE_TRAIN_STEPS, b, per_step, eval_launches)
        expect = {k: v * len(steps) + eval_launches[k] for k, v in per_step.items()}
        if totals != expect:
            raise AssertionError(f"23 {recipe} bf16: launch totals {totals}, expected {expect}")
        shapes = sorted({s["shapes"]["x" if recipe == "vosingle" else "semantic_ids"] for s in steps})
        if recipe == "vosingle" and shapes != [(6, 832, 80)] or recipe == "cosingle" and any(
                len(sh) != 2 or sh[0] != 10 or not 576 <= sh[1] <= 2048 for sh in shapes):
            raise AssertionError(f"23 {recipe}: batches {shapes}")
        f32_per_step = {k: v for k, v in per_step.items() if k != "rotary"} | {"rotary": 0}
        f32_steps, f32_evals, f32_totals, f32_peak, f32_s, _ = run_train_cli(
            [*common, *[a for a in flags if a != "--bf16"], "--dev_base_dir", train_dir, "--num_eval_files", "0",
             "--run_name", f"{recipe}_f32"], evaluate_name, SINGLE_F32_STEPS, resume=False)
        check_steps(f"23 {recipe} f32", f32_steps, f32_per_step)
        if len(f32_steps) != SINGLE_F32_STEPS or f32_evals or f32_totals != {
                k: v * SINGLE_F32_STEPS for k, v in f32_per_step.items()}:
            raise AssertionError(f"23 {recipe} f32: {len(f32_steps)} steps, {len(f32_evals)} evals, totals "
                                 f"{f32_totals}")
        cfg = cfgs[recipe]
        params = (A if recipe == "vosingle" else T).init(torch.Generator(device="cuda").manual_seed(5), cfg)
        loss_fn = (loop.acoustic_loss_fn(cfg, cond_drop_prob=0.3, dtype=torch.bfloat16) if recipe == "vosingle"
                   else loop.t2s_loss_fn(cfg, dtype=torch.bfloat16))
        split_training_step(results, f"single_{recipe}_split_ms", params, loss_fn, single_batch(recipe, train_dir),
                            n=3, idle_key=f"single_{recipe}_idle")
        del params
        if recipe == "vosingle":
            shape, causal, rotary = (6, 16, 832, 64), False, True
        else:
            shape, causal, rotary = (10, 8, max(sh[1] for sh in shapes) + 2, 64), True, False
        holds = {dt: check_flash_training_case(*shape, getattr(torch, dt), 2300, shape[2], rotary, causal)
                 for dt in ("bfloat16", "float32")}
        small = (check_small_training_against_cpu(single=True, adam_bound=True) if recipe == "vosingle"
                 else check_small_t2s_training_against_cpu(two_output=False, adam_bound=True))
        f32_ms = sorted(s["ms"] for s in f32_steps[1:])
        out[recipe] = {"bf16": {"ms_per_step_median": median, "samples_per_s": b / (median / 1e3),
                                "peak_gib": peak_gb, "run_s": first_s, "resume_s": resume_s,
                                "eval_s": evals[0]["s"], "eval": {k: v for k, v in evals[0].items() if k != "launches"},
                                "launches_per_step": per_step, "eval_launches": eval_launches, "totals": totals,
                                "split_ms": results[f"single_{recipe}_split_ms"],
                                "idle": results[f"single_{recipe}_idle"], "losses": [s["loss"] for s in steps]},
                       "f32": {"ms_per_step_median": f32_ms[len(f32_ms) // 2], "peak_gib": f32_peak, "run_s": f32_s,
                               "launches_per_step": f32_per_step, "losses": [s["loss"] for s in f32_steps]},
                       "batches": [list(sh) for sh in shapes], "kernel_shape": list(shape), "holds": holds,
                       "small_card_vs_cpu": small}
        log(f"23 {recipe} training at full width ({card_line()}): " + json.dumps(out[recipe], default=str))
    results["single_training"] = out
    results["single_training_wall_s"] = time.time() - t0
    log(f"23 training wall {time.time() - t0:.1f} s")


def run_single_family(results, root):
    """Phase 23: run_single_generation on phase 6's assets in `root`, then
    run_single_training under root/single_train."""
    t0 = time.time()
    run_single_generation(results, root)
    run_single_training(results, os.path.join(root, "single_train"))
    results["single_wall_s"] = time.time() - t0
    log(f"phase 23 wall {results['single_wall_s']:.1f} s")


def single_mode() -> int:
    """`python3 chip_smoke.py --single`: phase 23 alone on a fresh phase 6
    asset directory (one dialogue script), ending with the same `ok` line.
    The kernels build on first use."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from covomix_tpu_torch.ops import vocoder_tail as VT

    t_start = time.time()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    root = os.path.join(VT.BUILD_DIR, "smoke_single")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        write_dialogue_assets(root, n_scripts=1)
        run_single_family(results, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"total chip_smoke --single time {time.time() - t_start:.1f} s")
    log("single family: " + json.dumps({"generation": results["single_generation"],
                                        "training": results["single_training"]}, default=str))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


# registers per thread of the dh-64 flash kernels (ptxas, CUDA 12.8), held
# to the counts of their first build: the bf16 TMA + wgmma forward's four
# forms (<dh, lse, causal>), the rotary pre-pass, the TMA + wgmma backward
# pair's three forms each (<dh, causal, tables>), the rotary transpose that
# follows a backward kernel without the fused epilogue, the f32 tiled
# forward's two forms and the f32 tiled dQ and dK/dV's two forms each
# (<dh, causal>; the tables are a run-time argument). ptxas caps the wgmma
# kernels at 168 (two blocks of 160 threads per SM) and the f32 tiled
# kernels at 255 (two blocks of 128); none may spill.
FLASH_REGS = {"flash_fwd_wgmma<Li64ELb0ELb0E>": 155, "flash_fwd_wgmma<Li64ELb1ELb0E>": 155,
              "flash_fwd_wgmma<Li64ELb0ELb1E>": 162, "flash_fwd_wgmma<Li64ELb1ELb1E>": 162,
              "flash_rotary_halfsplit_bf16<Li64E>": 48,
              "flash_bwd_dq_wgmma<Li64ELb0ELb0E>": 122, "flash_bwd_dq_wgmma<Li64ELb1ELb0E>": 124,
              "flash_bwd_dq_wgmma<Li64ELb0ELb1E>": 122,
              "flash_bwd_dkv_wgmma<Li64ELb0ELb0E>": 168, "flash_bwd_dkv_wgmma<Li64ELb1ELb0E>": 168,
              "flash_bwd_dkv_wgmma<Li64ELb0ELb1E>": 168, "flash_rotary_transpose_bf16<Li64E>": 48,
              "flash_fwd_f32_tile<Li64ELb0E>": 209, "flash_fwd_f32_tile<Li64ELb1E>": 217,
              "flash_bwd_dq_f32_tile<Li64ELb0E>": 168, "flash_bwd_dq_f32_tile<Li64ELb1E>": 168,
              "flash_bwd_dkv_f32_tile<Li64ELb0E>": 211, "flash_bwd_dkv_f32_tile<Li64ELb1E>": 215}


# The fused vocoder kernels (`<type, channel padding, tail>`, all eight the
# library instantiates): 512 threads per block cap a thread at 128
# registers, and ptxas spills beyond; none may spill. The f32 forms hold
# their conv's R x 8 accumulators (R up to 4) at that cap.
VOC_REGS = {"vocoder_fused_kernel<13__nv_bfloat16Li64ELb0E>": 124, "vocoder_fused_kernel<13__nv_bfloat16Li32ELb1E>": 123,
            "vocoder_fused_kernel<13__nv_bfloat16Li32ELb0E>": 128, "vocoder_fused_kernel<13__nv_bfloat16Li64ELb1E>": 121,
            "vocoder_fused_kernel<fLi64ELb0E>": 128, "vocoder_fused_kernel<fLi32ELb1E>": 127,
            "vocoder_fused_kernel<fLi32ELb0E>": 128, "vocoder_fused_kernel<fLi64ELb1E>": 128}


def parse_ptxas(name, build_log, regs, spills):
    """Log ptxas's registers, spills and wgmma notes per kernel of one
    library's build log into regs / spills ({kernel: count})."""
    kernel = "?"
    for line in build_log.splitlines():
        if "Compiling entry function" in line:   # the kernel's name, length-prefixed in the mangled one
            m = re.search(r"\d+((?:flash|vocoder)_[a-z_0-9]+)I(.*?)EEv", line)
            kernel = f"{m.group(1)}<{m.group(2)}>" if m else line.split("'")[1]
        elif "Used" in line or "spill" in line or "wgmma.mma_async" in line:
            log(f"  ptxas {name} {kernel}: " + line.strip().replace("ptxas info    : ", ""))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs[kernel] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills[kernel] = int(m.group(1)) + int(m.group(2))


def parallel_builds(builds, libs):
    """Run the build callables all at once; log each library's seconds."""
    def timed(build):
        start = time.time()
        build()
        return time.time() - start

    t0 = time.time()
    with ThreadPoolExecutor(len(builds)) as pool:
        seconds = list(pool.map(timed, builds))
    log(f"built {[os.path.relpath(p, REPO) for p in libs]} in {time.time() - t0:.1f} s, each (s): "
        + ", ".join(f"{os.path.basename(p)} {t:.1f}" for p, t in zip(libs, seconds)))


def build_kernels():
    """Build every kernel library from the checkout's sources, all nvcc runs
    started together: the flash kernels for the serving / training head dim
    and the edge head dims checked below, and the fused vocoder library. Logs
    ptxas's registers, spills and wgmma notes per kernel of the dh-64 flash
    library and the vocoder library; returns ({kernel: registers},
    {kernel: spill bytes}) of those."""
    from covomix_tpu_torch.ops import flash_attention as FA, vocoder_tail as VT

    dhs = (SERVING_DH,) + EDGE_DH
    parallel_builds([lambda dh=dh: FA.KERNEL.build(dh) for dh in dhs] + [VT.LIBRARY.build],
                    [FA.KERNEL.lib_path(dh) for dh in dhs] + [VT.LIBRARY.lib_path()])
    regs, spills = {}, {}
    parse_ptxas(f"flash dh {SERVING_DH}", FA.KERNEL.build_logs.get(SERVING_DH, ""), regs, spills)
    parse_ptxas("vocoder_tail", VT.LIBRARY.build_log, regs, spills)
    return regs, spills


def check_registers(regs, spills, expected=None):
    """The kernels of `expected` ({kernel: registers}; default FLASH_REGS and
    VOC_REGS) keep their register counts, with no spills."""
    expected = expected or {**FLASH_REGS, **VOC_REGS}
    found = {k: regs.get(k) for k in expected}
    spilled = {k: spills.get(k) for k in expected}
    log(f"registers {found} (expected {expected}), spill bytes {spilled}")
    if found != expected or any(v != 0 for v in spilled.values()):
        raise AssertionError("a flash or vocoder kernel's register count changed, or it spills")


def kernel_entry(results, key, name, source, replaces, launches, with_prepass=False, **extra) -> dict:
    """One entry of the `kernels` line from results[f"{key}_*"]: `ms` back to
    back, `device_ms` behind a sleep (the same for the library call where
    there is one), and with `with_prepass` the forward's time with the rotary
    pre-pass, as the path calls it."""
    entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
             "max_abs_err": results[f"{key}_max_abs_err"], "ms": results[f"{key}_ms"],
             "plain_ms": results[f"{key}_plain_ms"], "bound_ms": results[f"{key}_bound_ms"],
             "bound_by": results[f"{key}_bound_by"], "library_ms": results.get(f"{key}_library_ms"),
             "device_ms": results[f"{key}_device_ms"],
             "library_device_ms": results.get(f"{key}_library_device_ms")}
    if with_prepass:
        entry["ms_with_prepass"] = results[f"{key}_with_prepass_ms"]
        entry["device_ms_with_prepass"] = results[f"{key}_with_prepass_device_ms"]
    return {**entry, **extra}


def bench_shape_entry(results, key, *extra) -> dict:
    """A kernel's numbers at one of the bench's batched shapes (phase 15),
    for the `kernels` line."""
    return {k: results[f"{key}_{k}"] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                                                *extra)}


def plan_summary(results, key) -> dict:
    """The timed launch's block plan for the `kernels` line: tile, waves,
    shared bytes."""
    p = results[f"{key}_plan"]
    return {"tile": p["tile"], "waves": p["waves"], "smem": p["smem"]}


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "covomix_tpu_torch")):
        print("chip_smoke: covomix_tpu_torch/ not found beside this script; run from a checkout",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from covomix_tpu_torch.ops import flash_attention as FA, vocoder_tail as VT
    from covomix_tpu_torch.util.misc import round_up

    t_start = time.time()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # every library's nvcc starts now; the head-dim-64 flash and the vocoder libraries are ready in
    # ~20-25 s, the edge head dims in ~100-160 s: meanwhile the phases that need only those two and whose
    # time is mostly the card's (16: HiFi-GAN training, idle ~10 %; 9b: the f32 training cells) run. Their
    # timings are then taken with nvcc busy on the host's cores: `--gan` times phase 16 alone.
    results = {}
    with ThreadPoolExecutor(1) as pool:
        building = pool.submit(build_kernels)
        FA.KERNEL.build(SERVING_DH)
        VT.LIBRARY.build()
        log("phases 16 and 9b run while the edge head dims build: their ms a step, rates and idle shares are "
            "host-contended, not comparable with those phases timed alone")
        t0 = time.time()
        root = os.path.join(VT.BUILD_DIR, "smoke_gan")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        try:
            run_gan_training(results, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        for cell in F32_CELLS:
            root = os.path.join(VT.BUILD_DIR, f"smoke_{cell}_f32")
            shutil.rmtree(root, ignore_errors=True)
            try:
                run_f32_training(results, root, cell)
            finally:
                shutil.rmtree(root, ignore_errors=True)
        log(f"phases 16 and 9b (beside the edge head dims' builds) {time.time() - t0:.1f} s")
        regs, spills = building.result()
    check_registers(regs, spills)

    check_rotary_prepass(results)
    check_flash(results)
    check_flash_training(results)
    check_vocoder(results)
    valid_rows = run_serving(results)
    time_flash(results, "flash_serving", 8, 912, valid_rows)
    time_flash_host(results)
    time_vocoder_t512(results)
    root = os.path.join(VT.BUILD_DIR, "smoke_dialogue")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        t0 = time.time()
        write_dialogue_assets(root)
        log(f"dialogue assets (full-width checkpoints, scripts, prompts) written in {time.time() - t0:.1f} s")
        run_generation_cli(results, root, "dialogue", "covomix")
        frames = results["dialogue_flow_frames"]   # the Synthesizer's shape: CFG-doubled, bucketed, scalar valid_len
        time_flash(results, "flash", 2, round_up(frames, 128), frames)
        for kind, (x, up, blocks, post) in results.pop("dialogue_vocoder_inputs").items():
            time_vocoder(results, kind, kind, x, up, blocks, post)   # the main path's own inputs
        check_small_against_cpu()
        check_small_synth_against_cpu(os.path.join(root, "prompts"))
        paths = write_torch_checkpoints(root)
        run_serve_batch_from_torch(results, root, paths)
        run_hifigan_inference(results, root, paths["vocoder"])
        vomix, t2s = results["serving_models"][0], results["serving_t2s"]   # phase 21 evaluates with them
        spec_cfg, spec_params = run_speculative(results, root, results.pop("serving_models"))
        t0 = time.time()
        run_decode_graphs(results, results.pop("serving_t2s"), spec_cfg, spec_params)
        log(f"phase 14 wall {time.time() - t0:.1f} s")
        run_single_family(results, root)        # phase 23, on phase 6's checkpoints and prompts
    finally:
        shutil.rmtree(root, ignore_errors=True)
    run_phase21(results, os.path.join(VT.BUILD_DIR, "smoke_eval"), eval_models(vomix, t2s))
    del vomix, t2s
    root = os.path.join(VT.BUILD_DIR, "smoke_hubert")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        run_hubert(results, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    root = os.path.join(VT.BUILD_DIR, "smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    try:
        train_dir = run_training(results, root)
        split_vomix_step(results, train_dir, idle_key="train_idle")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    time_flash_training(results)
    time_flash_f32(results, "_f32", *F32_SHAPES["_f32"])
    check_small_training_against_cpu()
    root = os.path.join(VT.BUILD_DIR, "smoke_t2s")
    shutil.rmtree(root, ignore_errors=True)
    try:
        run_t2s_training(results, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    split_t2s_step(results)
    time_flash_causal(results)
    time_flash_f32(results, "_causal_f32", *F32_SHAPES["_causal_f32"])
    check_small_t2s_training_against_cpu()
    run_multi_step(results, os.path.join(VT.BUILD_DIR, "smoke_multi"))
    run_bench(results)
    root = os.path.join(VT.BUILD_DIR, "smoke_dp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        run_dp_training(results, root)
        run_parallel_training(results, root)    # phases 18-20, on phase 17's items and one-process references
    finally:
        shutil.rmtree(root, ignore_errors=True)

    launches = results["dialogue_launches"]     # this slice's main path: the per-file dialogue CLI
    # phase 13's path (speculative decode): the fit's causal kernels, the
    # speculative serving batch's and per-file run's forwards, pre-passes and
    # fused vocoder kernels
    spec_file, spec_serving, spec_fit = (results["spec_dialogue_launches"], results["spec_serving_launches"],
                                         results["spec_fit_launches"])
    flash_src, voc_src = "covomix_tpu_torch/csrc/flash_attention.cu", "covomix_tpu_torch/csrc/vocoder_tail.cu"
    # phase 15's path (the bench, all bf16): its totals by kernel, HuBERT's forwards apart from the flow's
    bench = results["bench_launches"]
    bench_hubert = results["bench_line"]["launches"]["hubert"]["fwd"]
    tpl = results["tp_launches"]     # phase 18: a rank step's launches per cell, at its H / tp heads
    ppl = results["pp_launches"]     # phase 19: a rank step's launches per cell (its stage's ticks; none under sp)
    bml = results["bmuf_launches"]   # phase 20: a BMUF rank step's launches per cell
    sdl = results["serve_dp_launches"]   # phase 20: a dp=2 serving rank call's launches, by dtype

    def staged(axis, dt, key):
        """Phase 19's launches of `key` per rank step, by cell, of the cells of `axis` in `dt`."""
        return {name: ppl[name][key] for name in ppl if PP_CELLS[name][2] == axis and PP_CELLS[name][0] == dt}

    def dispatched(cell, key):
        """Phase 22: the launches of `key` one captured dispatch of `cell` runs (recorded at its capture)."""
        return {cell: results["multi_step"][cell]["launches_per_dispatch"][key]}

    single_runs = results["single_generation"]["runs"]     # phase 23's generation CLI runs
    single_train = results["single_training"]             # phase 23's recipes

    def single(kind):
        """Phase 23: the launches of `kind` (flash, rotary, stage, tail) in each generation CLI run."""
        return {name[len("single_"):]: run["launches"][kind] for name, run in single_runs.items()}

    def single_step(recipe, dt, key):
        """Phase 23: a `recipe` step's launches of `key` in `dt`, and the hold at the recipe's shape."""
        rec = single_train[recipe]
        return {"single_launches_per_train_step": {f"{recipe}_{dt}": rec[dt]["launches_per_step"][key]},
                "single_check": {f"{recipe}_{dt}": rec["holds"]["bfloat16" if dt == "bf16" else "float32"][
                    key.replace("_causal", "")], "shape": rec["kernel_shape"]}}

    big = BENCH_FLASH_B
    kernels = [
        # the attention kernel alone; with the pre-pass, as the path calls it, in ms_with_prepass
        kernel_entry(results, "flash", "flash_attention_fwd", flash_src, "covomix_tpu/ops/flash_attention.py:162",
                     launches["flash"], with_prepass=True,
                     speculative_launches=spec_file["flash"] + spec_serving["fwd"],
                     serve_dp_launches_per_rank_call=sdl["bf16"]["fwd"],
                     adaptive_launches=results["adaptive"]["launches"],     # phase 21: sample_adaptive, bf16
                     single_launches=single("flash"),
                     single_eval_launches=single_train["vosingle"]["bf16"]["eval_launches"]["fwd"],
                     single_shapes={"covosinx_dialogue": bench_shape_entry(results, "single_flash", "with_prepass_ms",
                                                                           "library_ms")},
                     bench_launches=bench["fwd"] - bench_hubert,
                     bench_shapes={f"b{big}": bench_shape_entry(results, f"flash_bench_b{big}", "with_prepass_ms",
                                                                "library_ms")}),
        # the rotary half of the TPU kernel's fused rotary (`if fused_rotary:` in _flash_kernel), once per call
        kernel_entry(results, "flash_rotary", "flash_rotary_halfsplit", flash_src,
                     "covomix_tpu/ops/flash_attention.py:213", launches["rotary"],
                     speculative_launches=spec_file["rotary"] + spec_serving["rotary"],
                     bench_launches=bench["rotary"],
                     tp_launches_per_rank_step={name: tpl[name]["rotary"] for name in tpl},
                     pp_launches_per_rank_step=staged("pp", "bf16", "rotary"),
                     sp_launches_per_rank_step=staged("sp", "bf16", "rotary"),
                     bmuf_launches_per_rank_step=bml["bmuf_vomix_bf16"]["rotary"],
                     serve_dp_launches_per_rank_call=sdl["bf16"]["rotary"],
                     adaptive_launches=results["adaptive"]["rotary_launches"],
                     multi_step_launches_per_dispatch=dispatched("vomix_bf16", "rotary"),
                     single_launches=single("rotary"),
                     single_launches_per_train_step={"vosingle_bf16": single_train["vosingle"]["bf16"][
                         "launches_per_step"]["rotary"]}),
    ]
    for kind, replaces in (("stage", "covomix_tpu/ops/vocoder_tail.py:369"),
                           ("tail", "covomix_tpu/ops/vocoder_tail.py:209")):
        kernels.append(kernel_entry(results, kind, f"vocoder_fused_{kind}", voc_src, replaces, launches[kind],
                                    unfused_ms=results[f"{kind}_unfused_ms"], plan=plan_summary(results, kind),
                                    speculative_launches=spec_file[kind], bench_launches=bench[kind],
                                    bench_shapes={f"b{b}": bench_shape_entry(results, f"{kind}_bench_b{b}",
                                                                             "unfused_ms")
                                                  for b in BENCH_DETAIL_B},
                                    bench_check={f"b{BENCH_CHECK_B}": results[
                                        f"{kind}_bench_b{BENCH_CHECK_B}_max_abs_err"]},
                                    single_launches=single(kind),
                                    single_shapes={"covosingle_turn": bench_shape_entry(results, f"single_{kind}",
                                                                                        "unfused_ms")}))
    replaces = {"fwd_lse": "covomix_tpu/ops/flash_attention.py:162",
                "bwd_dq": "covomix_tpu/ops/flash_attention.py:502",
                "bwd_dkv": "covomix_tpu/ops/flash_attention.py:544"}
    train = results["train_launches"]     # this slice's main path: full-width VoMix training
    # phase 17's paths: the world-1 NCCL run (4 bf16 VoMix steps) and a dp=2 rank's step
    dp1, dp2 = results["dp_world1_launches"], results["dp2_launches"]
    for key, where in replaces.items():
        kernels.append(kernel_entry(results, key, f"flash_attention_{key}", flash_src, where, train[key],
                                    with_prepass=key == "fwd_lse",
                                    launches_per_train_step=train[key] // results["train_steps"],
                                    bench_launches=bench[key], dp_world1_launches=dp1[key],
                                    dp2_launches_per_rank_step=dp2["vomix_bf16"][key],
                                    tp_launches_per_rank_step={name: tpl[name][key] for name in tpl
                                                               if name.endswith("vomix_bf16")},
                                    pp_launches_per_rank_step=staged("pp", "bf16", key),
                                    sp_launches_per_rank_step=staged("sp", "bf16", key),
                                    bmuf_launches_per_rank_step=bml["bmuf_vomix_bf16"][key],
                                    multi_step_launches_per_dispatch=dispatched("vomix_bf16", key),
                                    parallel_depth=PAR_DEPTH, **single_step("vosingle", "bf16", key)))
    for dt in ("f32", "bf16"):     # this slice's main path: HuBERT extraction (f32, and --bf16)
        kernels.append(kernel_entry(results, f"hubert_fwd_{dt}", f"flash_attention_fwd_hubert_{dt}", flash_src,
                                    "covomix_tpu/ops/flash_attention.py:162", results[f"hubert_{dt}"]["launches"],
                                    bench_launches=bench_hubert if dt == "bf16" else 0,
                                    # phase 20: the f32 inference forward of a dp=2 serving rank call;
                                    # phase 21: the f32 file-level evals' and sample_regression's
                                    **({"serve_dp_launches_per_rank_call": sdl["f32"]["fwd"],
                                        "eval_files_launches": {
                                            **{k: v["launches"] for k, v in results["eval_files"].items()},
                                            "regression": results["adaptive"]["regression_launches"]}}
                                       if dt == "f32" else {})))
    for kind, where in (("stage", "covomix_tpu/ops/vocoder_tail.py:369"),
                        ("tail", "covomix_tpu/ops/vocoder_tail.py:209")):   # hifigan_inference --fuse_tail, f32
        kernels.append(kernel_entry(results, f"{kind}_f32", f"vocoder_fused_{kind}_f32", voc_src, where,
                                    results["hifi_launches"][kind], unfused_ms=results[f"{kind}_f32_unfused_ms"],
                                    plan=plan_summary(results, f"{kind}_f32"), bench_launches=0,
                                    # phase 16: the trained generator's export, vocoded with --fuse_tail
                                    gan_export_launches=results["gan_export_launches"][kind],
                                    gan_export_max_abs_err=results["gan_export_max_abs_err"][kind]))
    t2s = results["t2s_launches"]     # this slice's main path: full-width CoMix T2S training
    for key, where in replaces.items():
        key = f"{key}_causal"
        kernels.append(kernel_entry(results, key, f"flash_attention_{key}", flash_src, where, t2s[key],
                                    launches_per_train_step=t2s[key] // results["t2s_steps"],
                                    speculative_launches=spec_fit[key],
                                    speculative_fit_replays={"replays": results["spec_fit_replays"]["replays"],
                                                             "launches_per_replay": results["spec_fit_replays"][
                                                                 "launches_per_replay"][key]},
                                    bench_launches=bench[key],
                                    dp2_launches_per_rank_step=dp2["t2s_bf16"][key],
                                    tp_launches_per_rank_step={"tp2_t2s_bf16": tpl["tp2_t2s_bf16"][key]},
                                    bmuf_launches_per_rank_step=bml["bmuf_t2s_bf16"][key],
                                    multi_step_launches_per_dispatch=dispatched("t2s_bf16", key),
                                    parallel_depth=PAR_DEPTH, **single_step("cosingle", "bf16", key)))
    for cell, suffix in (("vomix", "_f32"), ("t2s", "_causal_f32")):   # f32 training at the recipes' precision
        runs = results[f"{cell}_f32_launches"]
        for key, where in replaces.items():
            count = runs[f"{key}_causal" if cell == "t2s" else key]
            kernels.append(kernel_entry(results, f"{key}{suffix}", f"flash_attention_{key}{suffix}", flash_src, where,
                                        count, launches_per_train_step=count // results[f"{cell}_f32_steps"],
                                        bench_launches=0, dp2_launches_per_rank_step=dp2[f"{cell}_f32"][
                                            f"{key}_causal" if cell == "t2s" else key],
                                        tp_launches_per_rank_step={f"tp2_{cell}_f32": tpl[f"tp2_{cell}_f32"][
                                            f"{key}_causal" if cell == "t2s" else key]},
                                        parallel_depth=PAR_DEPTH,
                                        **single_step("vosingle" if cell == "vomix" else "cosingle", "f32",
                                                      f"{key}_causal" if cell == "t2s" else key),
                                        **({"pp_launches_per_rank_step": staged("pp", "f32", key),
                                            "sp_launches_per_rank_step": staged("sp", "f32", key),
                                            "bmuf_launches_per_rank_step": bml["bmuf_vomix_f32"][key],
                                            "multi_step_launches_per_dispatch": dispatched("vomix_f32", key)}
                                           if cell == "vomix" else {})))
    log(f"total chip_smoke time {time.time() - t_start:.1f} s")
    log("speculative decode: " + json.dumps({"bench": results["spec_bench"], "decode": results["spec_decode"],
                                              "serving_wall_s": results["spec_serving_wall_s"],
                                              "serving_stages": results["spec_serving_stages"],
                                              "per_file_rtf": results["spec_dialogue_rtf"],
                                              "fit_step_ms": results["spec_fit_step_ms"],
                                              "fit_dispatch_ms_per_step": results["spec_fit_dispatch_ms_per_step"],
                                              "walls": results["spec_walls"]}))
    log("one-program decode: " + json.dumps({"decode": results["decode_graphs"], "speculative": results["decode_spec"],
                                               "idle": {**results["decode_idle"], "serving_batch": results["serving_idle"],
                                                        "vomix_bf16_step": results["train_idle"]},
                                               "captures": results["decode_captures"],
                                               "memory": results["decode_memory"]}, default=str))
    log("gan training: " + json.dumps(results["gan"]))
    log("data-parallel training: " + json.dumps(results["dp"]))
    log("tensor-parallel and FSDP training: " + json.dumps(results["tp"]))
    log("pipeline- and sequence-parallel training: " + json.dumps(results["pp"]))
    log("bmuf training and serving over dp: " + json.dumps({k: results[k] for k in ("bmuf", "serve_dp")}))
    log("data preparation and file-level evals: " + json.dumps({k: results[k] for k in
                                                              ("data_prep", "eval_files", "adaptive")}))
    log("multi-step training: " + json.dumps({"cells": results["multi_step"], "cli": results["multi_cli"]}))
    log("single family: " + json.dumps({"generation": results["single_generation"],
                                        "training": results["single_training"]}, default=str))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


# One tree's training cells, run from the root of that tree's checkout with
# this chip_smoke.py (its path the first argument, the cells the second), so
# both trees are driven and gated by the same code: the dh-64 flash library,
# of the cells asked for the bf16 VoMix training run and its step split, the
# bf16 CoMix T2S run and its split, the two f32 cells (the recipes' own
# precision: run and split), then, with an f32 cell, the f32 backward's
# device times at both training shapes; prints one "AB {json}" line.
AB_CELLS = """
import importlib.util, json, os, shutil, sys
sys.path.insert(0, os.getcwd())
spec = importlib.util.spec_from_file_location("chip_smoke_ab", sys.argv[1])
CS = importlib.util.module_from_spec(spec)
spec.loader.exec_module(CS)
cells = sys.argv[2].split(",")
from covomix_tpu_torch.ops import flash_attention as FA
FA.KERNEL.build(64)
root = os.path.join(os.getcwd(), "covomix_tpu_torch", "_build", "ab")
shutil.rmtree(root, ignore_errors=True)
r = {}
try:
    if "train" in cells:
        CS.split_vomix_step(r, CS.run_training(r, os.path.join(root, "vomix")))
    if "t2s" in cells:
        CS.run_t2s_training(r, os.path.join(root, "t2s"))
        CS.split_t2s_step(r)
    for cell in CS.F32_CELLS:
        if cell + "_f32" in cells:
            CS.run_f32_training(r, os.path.join(root, cell + "_f32"), cell)
finally:
    shutil.rmtree(root, ignore_errors=True)
f32 = any(c.endswith("_f32") for c in cells)
if f32:
    CS.f32_backward_times(r)
keys = [f"{c}_{p}_ms" for c in cells for p in ("step", "split")] + (CS.AB_KERNEL_KEYS if f32 else [])
print("AB " + json.dumps({k: r[k] for k in keys}), flush=True)
"""
AB_STEP_CELLS = ("train", "t2s", "vomix_f32", "t2s_f32")
AB_KERNEL_KEYS = [f"{name}{suffix}_{what}" for suffix in F32_SHAPES for name, what in (
    ("bwd_dq", "untabled_device_ms"), ("bwd_dkv", "untabled_device_ms"), ("backward", "device_ms"))]
AB_PAIRS = 10            # pairs of runs, each side first in half of them


def ab_training(other: str, cells=AB_STEP_CELLS, pairs=AB_PAIRS) -> int:
    """`python3 chip_smoke.py --ab-training DIR [CELLS [PAIRS]]`: the
    training cells (of AB_STEP_CELLS, all by default: VoMix and CoMix T2S in
    bf16 and in f32, AB_CELLS) of the checkout at DIR (another commit,
    unpacked with git archive) and of this one, one process per run, in
    `pairs` pairs ordered other, this, this, other, ... on one card (both
    trees' dh-64 libraries built first, in parallel; both driven by this
    script); logs every run's median step times, step splits (forward /
    backward / optimizer) and, with an f32 cell, f32 backward device times,
    then per cell and per part each tree's medians, the pairs (runs 2i and
    2i + 1) this tree won, and the spread between the other tree's
    quartiles: a gain is resolved when this tree wins nine tenths of the
    pairs and the medians differ by more than that spread."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    trees = {"other": os.path.abspath(other), "this": REPO}
    log(card_line())
    build = ("import os, sys; sys.path.insert(0, os.getcwd()); "
             "from covomix_tpu_torch.ops import flash_attention as FA; FA.KERNEL.build(64)")
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=d) for d in trees.values()]
    if any(p.wait() for p in procs):
        raise RuntimeError("a tree's flash library did not build")
    unknown = set(cells) - set(AB_STEP_CELLS)
    if unknown:
        raise ValueError(f"unknown A/B cells {sorted(unknown)}; the cells are {AB_STEP_CELLS}")
    runs = []
    for name in (("other", "this", "this", "other") * pairs)[:2 * pairs]:
        res = subprocess.run([sys.executable, "-c", AB_CELLS, os.path.abspath(__file__), ",".join(cells)],
                             cwd=trees[name], capture_output=True, text=True)
        line = [x for x in res.stdout.splitlines() if x.startswith("AB ")]
        if res.returncode != 0 or not line:
            raise RuntimeError(f"{name} tree's training cells failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        runs.append((name, json.loads(line[0][3:])))
        log(f"A/B run {len(runs)} ({name}, {trees[name]}): {runs[-1][1]}")

    def quantile(xs, f):
        xs = sorted(xs)
        i = f * (len(xs) - 1)
        return xs[int(i)] + (xs[min(int(i) + 1, len(xs) - 1)] - xs[int(i)]) * (i - int(i))

    measures = [(f"{cell} {part}", (lambda r, c=cell: r[f"{c}_step_ms"]) if part == "step" else
                 (lambda r, c=cell, q=part: r[f"{c}_split_ms"][q])) for cell in cells
                for part in ("step", "backward", "optimizer")]
    measures += [(key, lambda r, k=key: r[k]) for key in AB_KERNEL_KEYS if key in runs[0][1]]
    for what, get in measures:
        times = {n: [get(r) for m, r in runs if m == n] for n in trees}
        pairs = [dict(runs[i:i + 2]) for i in range(0, len(runs), 2)]
        wins = sum(get(p["this"]) < get(p["other"]) for p in pairs)
        med = {n: quantile(t, 0.5) for n, t in times.items()}
        spread = quantile(times["other"], 0.75) - quantile(times["other"], 0.25)
        resolved = wins >= 0.9 * len(pairs) and abs(med["this"] - med["other"]) > spread
        log(f"A/B {what} ms: median other {med['other']:.4f}, this {med['this']:.4f} "
            f"({med['this'] - med['other']:+.4f}); this tree faster in {wins} of {len(pairs)} pairs; other's "
            f"quartile spread {spread:.4f}; gain {'resolved' if resolved else 'unresolved'}")
    return 0


# ---------------------------------------------------------------------------
# python3 chip_smoke.py --vocoder: the fused vocoder kernels alone


MAIN_PATH_VOCODER = {"stage": (1, 40964, 125), "tail": (1, 163856, 62)}   # x of the per-file run's vocode
# x of hifigan_inference's 41 s file (f32; phase 11 times the kernels on the captured inputs)
HIFI_VOCODER = {"stage": (1, 42244, 125), "tail": (1, 168976, 62)}


def main_path_vocoder_inputs(kind, dtype=None):
    """Seeded random x of the stage or tail and the full-width weights of
    that stage (x, up, blocks, post): bf16 at the per-file main path's shape,
    or f32 at the 41 s hifigan_inference file's."""
    import torch

    dtype = dtype or torch.bfloat16
    shape = (MAIN_PATH_VOCODER if dtype == torch.bfloat16 else HIFI_VOCODER)[kind]
    up, blocks, post = vocoder_stage_params(500, kind == "tail", 7)
    x = torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(9), device="cuda").to(dtype)
    return x, up, blocks, post


def bench_mode() -> int:
    """`python3 chip_smoke.py --bench`: phase 15 alone (run_bench: the
    port's bench at full width and its gates, the fused kernels at the
    bench's batched shapes, the traced flow samples, the forward at the
    flow's B=64 shape), ending with the same `ok` line. The kernels build
    on first use."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    t_start = time.time()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run_bench({})
    log(f"total chip_smoke --bench time {time.time() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def gan_mode() -> int:
    """`python3 chip_smoke.py --gan`: phase 16 alone (run_gan_training: the
    covomix config's GAN training at full width through hifigan_train, its
    gates and records, the exported generator's fused vocode), ending with
    the same `ok` line. The fused vocoder library builds on first use."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from covomix_tpu_torch.ops import vocoder_tail as VT

    t_start = time.time()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    root = os.path.join(VT.BUILD_DIR, "smoke_gan")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        run_gan_training(results, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"total chip_smoke --gan time {time.time() - t_start:.1f} s")
    log("gan training: " + json.dumps({**results["gan"], "export_launches": results["gan_export_launches"],
                                       "export_max_abs_err": results["gan_export_max_abs_err"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def dp_mode() -> int:
    """`python3 chip_smoke.py --dp`: phase 17 alone (run_dp_training: the
    world-1 NCCL run through the train CLI against the run without a group,
    then two ranks on the card over gloo for both recipes in bf16 and f32
    and the GAN step, each held against one process), ending with the same
    `ok` line. The dh-64 flash library builds before the ranks start."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from covomix_tpu_torch.ops import vocoder_tail as VT

    t_start = time.time()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    root = os.path.join(VT.BUILD_DIR, "smoke_dp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        run_dp_training(results, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"total chip_smoke --dp time {time.time() - t_start:.1f} s")
    log("data-parallel training: " + json.dumps(results["dp"]))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def tp_mode() -> int:
    """`python3 chip_smoke.py --tp`: phase 18 alone (run_parallel_training on
    phase 17's VoMix and CoMix T2S items, its one-process references
    computed here), ending with the same `ok` line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from covomix_tpu_torch.ops import vocoder_tail as VT

    t_start = time.time()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    root = os.path.join(VT.BUILD_DIR, "smoke_tp")
    shutil.rmtree(root, ignore_errors=True)
    try:
        write_vomix_items(os.path.join(root, "vomix"), 24, 0)
        write_t2s_items(os.path.join(root, "t2s"), 24, 0)
        run_parallel_training(results, root, axes=(), bmuf_names=(), serve_dp=False)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"total chip_smoke --tp time {time.time() - t_start:.1f} s")
    log("tensor-parallel and FSDP training: " + json.dumps(results["tp"]))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def pp_mode(axis) -> int:
    """`python3 chip_smoke.py --pp` / `--sp`: phase 19's cells of that axis
    alone (run_parallel_training on phase 17's VoMix items, the one-process
    references computed here; with --sp also sample_sp), ending with the
    same `ok` line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from covomix_tpu_torch.ops import vocoder_tail as VT

    t_start = time.time()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    root = os.path.join(VT.BUILD_DIR, f"smoke_{axis}")
    shutil.rmtree(root, ignore_errors=True)
    try:
        write_vomix_items(os.path.join(root, "vomix"), 24, 0)
        run_parallel_training(results, root, tp_names=(), axes=(axis,), bmuf_names=(), serve_dp=False)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"total chip_smoke --{axis} time {time.time() - t_start:.1f} s")
    log("pipeline- and sequence-parallel training: " + json.dumps(results["pp"]))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase20_mode(bmuf: bool) -> int:
    """`python3 chip_smoke.py --bmuf` / `--serve_dp`: phase 20's BMUF cells
    (on phase 17's VoMix and CoMix T2S items) or its dp serving cell alone
    (run_parallel_training, the one-process references computed here),
    ending with the same `ok` line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from covomix_tpu_torch.ops import vocoder_tail as VT

    t_start = time.time()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    root = os.path.join(VT.BUILD_DIR, "smoke_bmuf" if bmuf else "smoke_serve_dp")
    shutil.rmtree(root, ignore_errors=True)
    try:
        if bmuf:
            write_vomix_items(os.path.join(root, "vomix"), 24, 0)
            write_t2s_items(os.path.join(root, "t2s"), 24, 0)
        else:
            os.makedirs(root)
        run_parallel_training(results, root, tp_names=(), axes=(), bmuf_names=tuple(BMUF_CELLS) if bmuf else (),
                              serve_dp=not bmuf)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"total chip_smoke --{'bmuf' if bmuf else 'serve_dp'} time {time.time() - t_start:.1f} s")
    log("bmuf training and serving over dp: " + json.dumps({k: results[k] for k in ("bmuf", "serve_dp")
                                                             if k in results}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def vocoder_mode() -> int:
    """`python3 chip_smoke.py --vocoder`: build only the fused vocoder
    library, log ptxas's registers and spills, run check_vocoder's cases,
    time both kernels at T=512 and at the per-file main path's shapes on
    seeded random inputs with full-width weights (each timed output held
    against its plain version); hold VOC_REGS last, so that a build with
    new counts still prints every timing."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from covomix_tpu_torch.ops import vocoder_tail as VT

    t_start = time.time()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if os.path.exists(VT.LIBRARY.lib_path()):   # ptxas's counts come from the build's log: always build
        os.remove(VT.LIBRARY.lib_path())
    parallel_builds([VT.LIBRARY.build], [VT.LIBRARY.lib_path()])
    regs, spills = {}, {}
    parse_ptxas("vocoder_tail", VT.LIBRARY.build_log, regs, spills)
    results = {}
    check_vocoder(results)
    time_vocoder_t512(results)
    for kind in MAIN_PATH_VOCODER:
        time_vocoder(results, kind, kind, *main_path_vocoder_inputs(kind))
        time_vocoder(results, f"{kind}_f32", kind, *main_path_vocoder_inputs(kind, torch.float32))
    check_registers(regs, spills, VOC_REGS)
    log(f"total chip_smoke --vocoder time {time.time() - t_start:.1f} s")
    log(json.dumps({"vocoder": {k: v for k, v in results.items() if k.startswith(("stage", "tail"))}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# python3 chip_smoke.py --flash-f32: the f32 forward at head dim 64 alone

HUBERT_FLASH_BATCH = (2, 2499, [2249, 2499])   # rows, frames, valid frames of the largest HuBERT flash batch


def flash_f32_mode() -> int:
    """`python3 chip_smoke.py --flash-f32`: build only the dh-64 flash
    library (always, since ptxas's counts come from the build log), log its
    kernels' registers and spills, run every f32 dh-64 case of check_flash,
    check_flash_training and check_flash_causal (every form of the forward,
    dQ and dK/dV, the in-kernel rotary and the backward's rotary transpose
    bit for bit, autograd), time the forward at the largest HuBERT batch's
    shape in f32 and bf16 beside SDPA (seeded inputs) and the f32 training
    kernels at both training shapes (time_flash_f32), and hold FLASH_REGS
    last, so that a build with new counts still prints every timing."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from covomix_tpu_torch.ops import flash_attention as FA

    t_start = time.time()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    if os.path.exists(FA.KERNEL.lib_path(SERVING_DH)):
        os.remove(FA.KERNEL.lib_path(SERVING_DH))
    parallel_builds([lambda: FA.KERNEL.build(SERVING_DH)], [FA.KERNEL.lib_path(SERVING_DH)])
    regs, spills = {}, {}
    parse_ptxas(f"flash dh {SERVING_DH}", FA.KERNEL.build_logs[SERVING_DH], regs, spills)
    results = {}
    check_flash(results, f32_dh64=True)
    check_flash_training(results, f32_dh64=True)
    check_flash_causal(results, f32_dh64=True)
    b, t, valid = HUBERT_FLASH_BATCH
    for dtype, key in ((torch.float32, "hubert_fwd_f32"), (torch.bfloat16, "hubert_fwd_bf16")):
        time_flash_hubert(results, key, dtype, b, t, valid)
    for suffix, shape in F32_SHAPES.items():
        time_flash_f32(results, suffix, *shape)
    check_registers(regs, spills, FLASH_REGS)
    log(f"total chip_smoke --flash-f32 time {time.time() - t_start:.1f} s")
    log(json.dumps({"flash_f32": {k: v for k, v in results.items() if k.startswith("hubert") or k.endswith(
        tuple(f"{suffix}_{what}" for suffix in F32_SHAPES for what in ("ms", "device_ms", "bound_ms")))}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# python3 chip_smoke.py --vocoder-split DIR: where the fused kernels' time goes


def split_sources(text: str) -> dict:
    """The fused vocoder source `text` as three variants: "full" as it is;
    "no_mrf" without the MRF (`// 3. the MRF` up to `// 4. epilogue`, and the
    weight ring's first fills in the kernel's prologue, whose copies the MRF
    would have waited for); "staging" without the MRF and the epilogue (the
    input frames and the upsample alone). The kernels' times of the three
    split each into staging + upsample / MRF / epilogue."""
    head, rest = text.split("  // 3. the MRF", 1)
    _, epilogue = rest.split("  // 4. epilogue", 1)
    _, end = epilogue.split("\n}\n\nconstexpr int kErrChannels", 1)
    before, kernel = head.split("vocoder_fused_kernel(Params<T> p) {", 1)
    prologue, body = kernel.split("  // 1. the block's input frames", 1)
    prologue = "\n".join(line for line in prologue.split("\n") if "fill_stage<" not in line)
    head = f"{before}vocoder_fused_kernel(Params<T> p) {{{prologue}  // 1. the block's input frames{body}"
    return {"full": text, "no_mrf": f"{head}  // 4. epilogue{epilogue}",
            "staging": f"{head}\n}}\n\nconstexpr int kErrChannels{end}"}


# One tree's split, run from the root of that tree's checkout with this
# file's split_sources output written into the tree's (git-ignored) build
# directory, compiled against the tree's own headers: each variant
# built into its own library (in parallel), then the stage and tail timed on
# the card alone (behind a sleep) at the per-file shapes in bf16 and the 41 s
# hifigan_inference file's in f32, seeded random inputs, full-width weights;
# prints one "SPLIT {json}" line.
SPLIT_CELL = """
import json, os, sys
from concurrent.futures import ThreadPoolExecutor
sys.path.insert(0, os.getcwd())
import torch
from covomix_tpu_torch.models import vocoder as V
from covomix_tpu_torch.ops import vocoder_tail as VT
from covomix_tpu_torch.ops.cuda_build import build_library
variants, shapes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
def build(name):
    path = os.path.join(VT.BUILD_DIR, f"libvocoder_split_{name}.so")
    build_library(os.path.join(VT.BUILD_DIR, f"_split_{name}.cu"), path, ["-I" + os.path.dirname(VT.SOURCE)])
    return path
with ThreadPoolExecutor(len(variants)) as pool:
    paths = dict(zip(variants, pool.map(build, variants)))
cfg = V.VocoderConfig()
p = V.init_generator(torch.Generator(device="cuda").manual_seed(7), cfg, device="cuda")
n = len(cfg.resblock_kernel_sizes)
def time_ms(fn, iters):
    fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000); a.record()
    for _ in range(iters): fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / iters
out = {}
for name in variants:
    VT.LIBRARY = VT.VocoderTailLibrary()
    VT.LIBRARY.lib_path = lambda path=paths[name]: path
    for kind, dt, shape in shapes:
        i = len(cfg.upsample_rates) - (1 if kind == "tail" else 2)
        up, blocks, post = p["ups"][i], p["resblocks"][i * n:(i + 1) * n], p["conv_post"] if kind == "tail" else None
        dtype = getattr(torch, dt)
        x = torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(9), device="cuda").to(dtype)
        packed = VT.pack_weights(up, blocks, post, (3, 7, 11), ((1, 3, 5),) * 3, dtype, x.device)
        kern = VT.TAIL if kind == "tail" else VT.STAGE
        out[f"{kind}_{dt}_{name}"] = time_ms(lambda: kern(x, packed), 10 if dt == "float32" else 20)
print("SPLIT " + json.dumps(out), flush=True)
"""


def vocoder_split(other: str) -> int:
    """`python3 chip_smoke.py --vocoder-split DIR`: the fused stage and tail
    of the checkout at DIR (another commit, unpacked with git archive) and of
    this one split into staging + upsample / MRF / epilogue by timing the
    split_sources variants (one process per tree, in the order other, this,
    this, other; ms on the card alone); logs each run and each tree's means."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    trees = {"other": os.path.abspath(other), "this": REPO}
    log(card_line())
    for tree in trees.values():
        build = os.path.join(tree, "covomix_tpu_torch", "_build")
        os.makedirs(build, exist_ok=True)
        with open(os.path.join(tree, "covomix_tpu_torch", "csrc", "vocoder_tail.cu")) as f:
            for name, text in split_sources(f.read()).items():
                with open(os.path.join(build, f"_split_{name}.cu"), "w") as g:
                    g.write(text)
    shapes = [(kind, "float32", HIFI_VOCODER[kind]) for kind in HIFI_VOCODER] + [
        (kind, "bfloat16", MAIN_PATH_VOCODER[kind]) for kind in MAIN_PATH_VOCODER]
    args = [json.dumps(["full", "no_mrf", "staging"]), json.dumps(shapes)]
    runs = []
    for name in ("other", "this", "this", "other"):
        res = subprocess.run([sys.executable, "-c", SPLIT_CELL, *args], cwd=trees[name], capture_output=True,
                             text=True)
        line = [x for x in res.stdout.splitlines() if x.startswith("SPLIT ")]
        if res.returncode != 0 or not line:
            raise RuntimeError(f"{name} tree's split failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        runs.append((name, json.loads(line[0][6:])))
        log(f"split run {len(runs)} ({name}, {trees[name]}): {runs[-1][1]}")
    for name in trees:
        ms = {k: sum(r[k] for n, r in runs if n == name) / 2 for k in runs[0][1]}
        for kind, dt, _ in shapes:
            full, no_mrf, staging = (ms[f"{kind}_{dt}_{v}"] for v in ("full", "no_mrf", "staging"))
            log(f"split {name} {kind} {dt} (device ms, mean of 2 runs): total {full:.4f} = staging + upsample "
                f"{staging:.4f} + MRF {full - no_mrf:.4f} + epilogue {no_mrf - staging:.4f}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab-training"]:
        sys.exit(ab_training(sys.argv[2], *([sys.argv[3].split(",")] if len(sys.argv) > 3 else []),
                             *([int(sys.argv[4])] if len(sys.argv) > 4 else [])))
    if sys.argv[1:2] == ["--bench"]:
        sys.exit(bench_mode())
    if sys.argv[1:2] == ["--vocoder"]:
        sys.exit(vocoder_mode())
    if sys.argv[1:2] == ["--gan"]:
        sys.exit(gan_mode())
    if sys.argv[1:2] == ["--dp"]:
        sys.exit(dp_mode())
    if sys.argv[1:2] == ["--tp"]:
        sys.exit(tp_mode())
    if sys.argv[1:2] in (["--pp"], ["--sp"]):
        sys.exit(pp_mode(sys.argv[1][2:]))
    if sys.argv[1:2] in (["--bmuf"], ["--serve_dp"]):
        sys.exit(phase20_mode(sys.argv[1] == "--bmuf"))
    if sys.argv[1:2] in (["--data_prep"], ["--eval_files"]):
        sys.exit(phase21_mode(sys.argv[1][2:]))
    if sys.argv[1:2] == ["--multi_step"]:
        sys.exit(multi_step_mode())
    if sys.argv[1:2] == ["--single"]:
        sys.exit(single_mode())
    if sys.argv[1:2] == ["--flash-f32"]:
        sys.exit(flash_f32_mode())
    if sys.argv[1:2] == ["--vocoder-split"]:
        sys.exit(vocoder_split(sys.argv[2]))
    sys.exit(main())
