#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (resolution_pde_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises (exit code != 0):
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: the CUDA kernels, from resolution_pde_tpu_torch/csrc;
  3. K1f, the fused FeedForward forward, against its plain PyTorch
     version: bf16 (its tensor-core products) at the train shape (LayerNorm
     and residual) and at ragged shapes (24->40->40->24 without either and
     with the exact GELU; 24->40 with both; the saved pre-activations,
     checked too; f32 x, residual and output); f32 (its CUDA-core products
     on f32_tile_gemm) at ragged shapes (24->40->40->24, 30->50->50->30,
     saved pre-activations, one layer, bf16 x, residual and output), at
     factor-4 widths 160, 192 and 256 with and without the saved
     pre-activations, at 64->3072->64 (fused_ff_fwd_kernel, the route of chains
     too wide for f32_tile_gemm's buffers) and at the train shape, two
     calls there compared bit for bit; bf16 at width 128's chain
     (128->512->512->128, LayerNorm and residual) at the train shape's
     rows, as the width-128 model of phase 8 runs it; f32 at FFNO1D's
     chain (128->512->512->128, exact GELU, LayerNorm, no residual) on
     16 x 512 rows, timed, two calls compared bit for bit; the factor-4
     chain at width 512 in bf16 (16-row tiles) and f32, with and without
     the saved pre-activations, on 4,096 rows, timed; each case with the
     planner's route and tile rows;
  4. K1b, its backward kernel, against the plain backward: bf16 (its
     tensor-core products) at the train shape with LayerNorm, at a ragged
     shape without and at a ragged one-layer shape with; f32 (its CUDA-core
     products on weights streamed through shared memory) at the ragged
     shape, at 30->50->50->30 with LayerNorm, at a one-layer shape with
     LayerNorm, with bf16 x, g and dx, and at the train shape, two calls
     there compared bit for bit, and at factor-4 widths 160, 192 and 256
     (column chunks, shorter tiles) recomputed and with saved
     pre-activations; the saved-pre-activation variant in bf16
     (ff_impl 'fused_saved'); bf16 at width 128's chain at the train
     shape's rows, recomputed and saved; f32 at FFNO1D's chain on 16 x
     512 rows, timed, two calls bit for bit; factor-4 chains at widths 320
     and 512 in f32 and bf16, recomputed and saved (their
     pre-activations in device memory); each case with its tile rows.
     Then the launchers' Python mirrors of the planners against the
     planners: the staged route's fit (rpde_spectral_staged_fits) over
     3,242 shapes, K1b's tile rows over 540 chains, K1f's route and tile
     rows over 56 chains (the bench chain, width 128's, factor 4 at 320
     and 512, a ragged chain and the first factor-4 chains no bf16 tile
     fits), and K1f's launcher refusing such a chain with a ValueError;
  5. K2, the spectral axis pass, against its plain version on the card:
     bf16 (the staged route: three tensor-core products through device
     memory) at the train shape along W and along H read in place and
     added into acc, each timed, and at ragged shapes (n = 32 with m = 17;
     n = 40; C = 24 -> O = 40 along H with acc; f32 x and out; C = 5 ->
     O = 3); its f32 mode (K3, IEEE f32 products
     on the CUDA cores) at the train shape along W and along H with acc,
     each timed, at the same ragged shapes and with bf16 x and out, at
     wider channels (128 -> 128 at n = 256, timed; 96 -> 128 along H with
     acc; 200 -> 136), and two calls on the same inputs compared bit for
     bit; the f32 passes beyond one launch of K3, in chunks of modes and
     channels (m = 80 at n = 160, and 264 -> 72 with f32 and with bf16 x
     and out), each with its count of launches; the bf16 passes at wider
     shapes (128 -> 128 along W and along H with acc, 256 -> 256, each
     timed; m = 72 at n = 160; 264 -> 200; f32 x and out at 112; 117 ->
     131 with f32 and bf16 x and out; 104 channels; two calls bit for
     bit); each case with its route; and both axes at 48 x 64 against the
     CPU;
  6. the K2/K3 adjoint (the same kernels, transposed factors and weight)
     against the plain adjoint: bf16 at the train shape along W and along
     H with acc, each timed, and 40 -> 24 channels; f32 (K3's adjoint) the
     same, and 136 -> 200 channels, and in chunks at m = 80 and 72 ->
     264; bf16 on the staged route at 128 -> 128 (W, and H with acc) and
     256 -> 256, timed, and at m = 72; the two-axis conv's input
     and weight gradients against the same on the CPU; in f32 the adjoint
     and the weight gradient against autograd of the plain pass;
  7. the serving slice: FFNO2D at the width of bench.py (random weights
     from a seed) behind ServingEngine on the GPU, one CUDA graph per
     bucket (8 x {64², 128², 256²} and a 4-step forecast, in bf16 and in
     the f32-exact mode; each capture's seconds and launches, the peak
     memory with all captured), serving predict and forecast requests
     whose kernels' executions inside the replays torch.profiler counts
     by symbol name (K1f and the staged K2 or K3, once a layer and twice
     a layer); replay against the same engine run eagerly; one predict in
     bf16 and one in f32 against the same weights on the CPU through the
     plain versions; the median predict latency per bucket, graph and
     eager;
  8. the train slice: the same model trained through the port's Trainer on
     bench.py's synthetic task (8 x 256², y = x rolled by 7 along W): 3
     warm steps and 20 timed ones, each launching every kernel of the step
     the counted number of times; every parameter's gradient finite and
     non-zero; one step's gradients at 128² in bf16 and in the f32-exact
     mode against the same weights on the CPU in f32; 5 f32-exact steps
     at 8 x 256² (the median of the last 3 logged); 3 steps of
     'fused_saved'; and a resume from a checkpoint repeating two steps'
     losses bit for bit; then FFNO2D at width 128 on 'pallas2' in bf16,
     every spectral pass and adjoint on the staged route (counted): a
     predict of 5 and 3 Trainer steps at 8 x 256² (finite losses, every
     gradient finite and non-zero; their launches of the staged route, K1f
     and K1b counted and read just after them), the predict and one
     step's gradients
     at 2 x 128² against the same weights in f32 on the CPU;
  9. K4, the S4D Vandermonde reduction, and K5, the four Cauchy sums of
     the S4 DPLR kernel, against their plain versions through both of
     each kernel's entries (the fused one the model runs, which forms the
     operands in the launch, and the plane one) at the S4 serving shapes,
     at S4ND's (phase 17: 64 features, L = 64, 128, 256) and at a small
     ragged shape, timed in CUDA graphs; K4 at a slow
     decay (Re A = -1e-4, dt = 0.1), no farther from a float64
     evaluation than its plain version;
 10. the S4 serving slice: S4Model at the width of configs/model/s4_1d.yaml
     (mode dplr, K5) and s4d_1d.yaml (mode diag, K4), random weights from
     a seed, on the kernels' route behind ServingEngine on the GPU, a CUDA
     graph per bucket at batch 16 x L in {128, 256, 512}, serving predict
     requests (one of batch 5) each executing its kernel once per layer
     inside the replay; replay against eager on the same engine; the
     median latency per bucket, graph and eager; the device's idle share
     over 10 predicts at 16 x 512; one predict against the same weights
     on the CPU through the plain versions and against the jnp route on
     the GPU; backward() through the kernels' route must raise;
 10b. the S4 family trained, then served: s4_1d.yaml and s4d_1d.yaml as
     shipped (jnp route, dropout 0.2, batch 16, the cosine schedule,
     ssm_lr through cli.common.build_trainer), 2 epochs on a synthetic
     stand-in for the KS files (32 x 51 frames x 512 points from SEED,
     split 24 / 4 / 4 as the train, valid and test files) through
     ks_window_splits (window 15): the loss falls and stays finite, the
     state-space rate is the ratio times the main one at every step, a
     checkpoint saved with block=False after each epoch (the stall timed
     beside a blocking save); the sweep at {32, ..., 512} and the window
     rollout of 16 steps at each; then the checkpoint served through
     ServingEngine.from_checkpoint into S4Model(kernel_impl='pallas'),
     graphs at 16 x {128, 256, 512}: replay against eager on the same
     engine, against the jnp route of the trained model within relative
     L2 1e-4, K5 or K4 executing 4 times a replay;
 11. the torch.fft spectral conv (the yaml config's route) on the card
     against the CPU at 128² and 256² with 64 modes, FFNO1D's conv at
     16 x {32, 64, 512} x 128 with 64 modes (the Nyquist bin kept at 32
     and 64), the FFT resize and
     the port's irfft (whose DC and Nyquist bins are read as real); then
     the flagship's
     command line: main_2d's main(argv) with its override
     strings, as a user runs it, in a temporary working directory, on a
     synthetic vorticity file (32 x 20 frames at 256², from SEED; .h5
     where h5py is installed, else .mat): run A, the yaml configs as
     shipped (width 64, 4 layers, 64 modes, dropout 0.1, torch.fft, the
     dense FeedForward, f32, batch 16), 2 epochs, launching no kernel; run
     B, the same on bench.py's kernel route (dropout 0, bf16, 'pallas2',
     'fused', tanh GELU), whose launches of K1f, K1b, K2 and its adjoint
     are counted and must each be at least one; each run's loss must fall,
     its test loss, sweep at {32, 64, 128, 256} and rollout there be
     finite; run C warm-starts the plain f32 route from B's checkpoint
     with 0 epochs, and the first test batch's predictions of B's and C's
     restored models agree within relative L2 3e-2 at each resolution;
     autoregressive_eval and frequency_evaluation on B's checkpoint and
     file repeat main_2d's sweep and rollout to 1e-6 and give a finite
     frequency table, launching K1f and K2; logged: the epochs' and the sweep's and rollout's seconds per
     resolution, peak memory, each run's median step, the loader's host
     ms a batch, and the device's idle share over one profiled epoch of
     run B;
 12. FFNO1D on generated KS: the port's generate_ks array part on the
     card (64 trajectories x 51 snapshots at 512 points, visc 0.075, L
     64, lmax 8, et 5, split 52 / 6 / 6 by generate_data's rule; finite,
     within the solver's amplitude bound, consecutive frames correlating
     above 0.8; its seconds), the solver's CUDA graph against its steps
     launched one by one (bit for bit, both timed, the eager steps
     profiled); main_1d's path for ffno_1d.yaml with
     ks_naive_true_mres1.yaml composed from cli.common's parts on those
     arrays, held in memory as the files generate_data writes
     (cli.generate_data.ks_in_memory; the factory reads the tree's
     512-point train file into one bucket, the eval swap its valid and
     test files), batch 16, 2 epochs: run A as shipped (dense
     FeedForward, dropout 0.2, f32), launching no kernel, and run B on the
     kernel route (dropout 0, ff_impl 'fused': K1f and K1b in f32, 4 of
     each a train step, counted); each run's loss must fall, its test
     loss, sweep at {32, ..., 512} and 16-step rollout there be finite;
     B's trained model on the card within relative L2 1e-4 of the same
     weights on the CPU through the plain versions at 512 and 64 points,
     and A's weights on the fused route within 1e-4 of A's dense one;
     B's checkpoint served through ServingEngine.from_checkpoint into
     FFNO1D(ff_impl='fused'), graphs at 16 x {128, 256, 512}: replay
     equal to eager bit for bit, K1f executing 4 times a replay; logged:
     epochs, median step, peak memory, sweep and rollout seconds a
     resolution, the median predict, graph and eager;
 13. the NS generator and the sweep runner: the port's generate_ns array
     part on the card (16 trajectories x 26 snapshots at 256², viscosity
     1e-03, 2,600 steps: finite, each snapshot's spatial mean zero; its
     seconds), the solver's CUDA graph against its steps launched one by
     one (bit for bit, both timed, the eager steps profiled) and the card
     against the CPU (64², 50 steps, relative L2 1e-4); the data written
     as a .mat file; then cli.sweep family=ns_models only=ffno2d_ns
     training.epochs=1 on it in a temporary working directory (the yaml
     files as shipped, 128² from the 256² file, launching no kernel): the
     leg green, its test loss, sweep and rollout at {32, ..., 256}
     finite, sweep.csv and sweep.md written with platform cuda(...), no
     .ok (a subset of the family) and no .incomplete;
 14. FNO and the Burgers and Darcy data paths: the port's generate_burgers
     array part on the card (64 trajectories x 11 snapshots at 1024, 512,
     256 and 128 points, 1,000 steps each, viscosity 0.001: finite,
     within the maximum principle; its seconds), the solver's CUDA graph
     against its steps launched one by one (bit for bit) and the card
     against the CPU (relative L2 1e-5); generate_darcy's (64 samples at
     128², beta 0.01: each batch's CG iterations and largest relative
     residual against the 1e-2 gate; the card's CG against the CPU's at
     32², 1e-4); FNO1d's train step at 16 x 1024 (median, and the
     device's busy time and idle share over 10 profiled steps); then, in
     a temporary working directory holding both as
     the files generate_data writes (cli.generate_data.burgers_in_memory,
     darcy_in_memory), cli.sweep for 1 epoch: baseline/fno1d_burger_naive
     (the yaml files as shipped), burger_ladder/
     ffno1d_burger_naive_true_mres on FFNO1D's kernel route (dropout 0,
     ff_impl 'fused': K1f and K1b in f32, counted) and darcy/fno2d_darcy;
     each leg green with a finite test loss and sweep (and rollout), its
     table written with platform cuda(...); the FNO legs launch no kernel;
 15. CNO, UNet and the active-matter path (run_cno), each leg through
     cli.sweep for 1 epoch in a working directory of its own, green with
     a finite test loss and sweep (and rollout), launching no kernel:
     ns_models/cno2d_ns_resize and cno2d_original_ns (cno_2d.yaml,
     cno_2d_original.yaml: 4 levels, multiplier 32, trained at 128²) on
     phase 13's NS, baseline/cno2d_ns_resize on it at 256² (resize
     training), ks_models/cno_1d_ks_naive and unet_1d_ks_naive on phase
     12's KS held as generate_data's files, ns_active_ladder/
     ffno2d_ns_active_t2 on phase 13's NS split over four files in the
     Well's layout (cli.generate_data.active_in_memory); the trained
     128² CNO2d served through ServingEngine.from_checkpoint (a graph at
     4 x 128², the replay equal to eager bit for bit, the median predict
     both ways); CNO2d's Trainer step at 16 x 128² and 16 x 256² (median,
     the device's busy time and idle share over 5 profiled steps, peak
     memory); CNO2d's forward on the card against the CPU in eval and
     train mode and the running statistics it leaves (relative L2 1e-4);
     a checkpoint resume of CNO2d held to 1e-4 on the losses, not bit for
     bit (torch's CUDA backward of the antialiased resize adds with
     atomics), the restored state equal bit for bit;
 16. the transformer operators (run_transformers), launching no kernel:
     ns_models/pos_ns (ScOT at the family's demo widths, 0.48 M
     parameters, trained at 128²) through cli.sweep for 1 epoch on phase
     13's NS, green with a finite test loss, sweep and rollout at 32-256;
     main_2d model=mgpt dataset=ns_gnot for 1 epoch on it strided to 32²
     (GNOTOperator on 1,024-node point clouds), a finite test loss and no
     sweep or rollout (ns_gnot.yaml has neither); the trained pos_ns ScOT
     served through ServingEngine.from_checkpoint (a graph at 4 x 128²,
     the replay equal to eager bit for bit, the median predict both
     ways); ScOT at pos.yaml's widths with one channel (101.3 M
     parameters): its Trainer step at 8 x 128² (median, the device's busy
     time and idle share over 3 profiled steps, peak memory) and its
     forward on the card against the CPU at a time a sample (relative L2
     1e-4);
 17. S4ND and the S4 base/sequence family (run_s4nd): main_2d
     model=s4_2d dataset=ns_naive model.d_input=1 model.d_output=1 at
     s4_2d.yaml's widths (d_model 64, 4 layers, d_state 64, dropout 0.2,
     diag, the 'jnp' route) on phase 13's NS strided to 128², 1 epoch,
     the losses, test loss, sweep and 16-step rollout at 32-256² each
     finite, no kernel launched; the trained S4ND served through
     ServingEngine.from_checkpoint into S4NDModel(kernel_impl='pallas')
     (K4) and a dplr S4NDModel at the same widths (K5), one graph a
     bucket at 8 x {64², 128², 256²}, a request a bucket counted by its
     kernel's executions in the replays (a layer and axis each), held
     against the 'jnp' route and the CPU (1e-4) and against eager, then
     each kernel layer's log_dt shifted in place in turn and the replay
     held against the 'jnp' route with the same shift (every kernel node
     runs in every replay), the median predict graphed and eager, the device time of a 256² predict
     by kernel; S4ND's Trainer step at 8 x 128² (median, busy time, idle
     share, kernels a step, the largest kernels, peak memory) and its
     forward against the CPU (1e-4); S4BaseSeqModel and S4DualSeqModel
     at their default widths in both modes, the convolution against the
     recurrence stepped over 16 steps on the card (rtol 2e-3, atol 2e-4,
     JAX's) and both against the CPU (1e-4). check_fft_path holds the
     port's irfftn at S4ND's padded shape there too.
The line before the last is the kernels' JSON record (ten entries: K1f,
K1b, the spectral pass and its adjoint each as a bf16 and an f32 entry,
the bf16 ones on the staged route with its own byte floor beside the
bound), each kernel with its time (the W pass's at the train shape, for
K2 and its adjoint), its plain version's, its launches on the main paths
and its bound (the larger of its bytes over 3.35 TB/s and the operations
its function needs over the peak rate of their type: for the spectral
pass, its DFTs counted as real FFTs where that is cheaper than the dense
products the kernels do); the K2 and K3 entries also give the H pass's
(added into acc) as h_acc_*, and the bf16 ones the same at width 128 as
w128_*; the f32 K1f and K1b entries also give FFNO1D's chain as
ffno1d_* (time, plain time, bound, error) and its launches on phase 12's
paths as ffno1d_launches (run B, and for K1f the served executions) and
on phase 14's Burgers leg as burgers_launches, the K4 and K5 entries
their executions in phase 17's S4ND replays as s4nd_launches, which
``launches`` includes, as it sums every path's; a kernel on a
serving path says in launches_counted_as that its
launches there are executions inside CUDA graph replays; the last line is
{"ok": true, "device": {...}}. Needs
CUDA: without it, it exits 1 and prints no result. Plain versions run with
TF32 off.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# bench.py:73-110: the flagship FFNO2D serving width
WIDTH, LAYERS, MODES, FACTOR, FF_LAYERS, BATCH, RES = 64, 4, 64, 4, 3, 8, 256
# the width of resolution_pde_tpu/configs/model/ffno_1d.yaml, run in FFNO2D
WIDE = 128
SEED = 0
# resolution_pde_tpu/configs/model/s4_1d.yaml and s4d_1d.yaml (d_input 15
# = the KS window, d_model 64, 4 layers, dropout 0.2, prenorm false; the
# S4 layers' default d_state 64, bidirectional, so 2 kernel channels);
# configs/training/default.yaml batch 16; configs/dataset/ks_s4.yaml
# original_res 512 (KS at 128, 256 and 512 points)
S4 = dict(d_input=15, d_output=1, d_model=64, n_layers=4, dropout=0.2,
          prenorm=False)
S4_STATE, S4_BATCH, S4_LENGTHS = 64, 16, (128, 256, 512)
# FFNO1D's FeedForward chain (configs/model/ffno_1d.yaml: width 128,
# factor 4, 3 layers)
FFNO1D_CHAIN = [WIDE, WIDE * FACTOR, WIDE * FACTOR, WIDE]

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, dense bf16 tensor-core and
# f32 (CUDA-core) FLOP/s
HBM_BYTES_S, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median time of ``fn`` on the device, from CUDA events around each run."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls: int = 50, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, replayed ``reps`` times between CUDA events; the median per
    call. For kernels of microseconds, whose eager launches leave the
    device idle between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound(ops: float, nbytes: float, peak: float) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over HBM_BYTES_S and
    the operations over ``peak``; and which of the two it is. A kernel
    whose cost no single PyTorch call reproduces has library_ms None."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None)


def _ff_cost(n, dims, ln, residual, dtype, passes, saved=0):
    """``bound`` of a FeedForward call, from the operations and bytes that
    ``fused_ff.cost`` counts (its docstring says what they are)."""
    from resolution_pde_tpu_torch.ops.kernels import fused_ff

    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    return bound(*fused_ff.cost(n, dims, ln, residual, dtype, passes, saved),
                 peak)


def _pass_cost(rows, n, c, o, m, io, cd, acc=False):
    """``bound`` of one spectral axis pass, from the operations and bytes
    that ``spectral_mix.pass_cost`` counts (each DFT as the cheaper of a
    real FFT and the dense product, ``spectral_mix.dft_flops``)."""
    from resolution_pde_tpu_torch.ops.kernels import spectral_mix

    return bound(*spectral_mix.pass_cost(rows, n, c, o, m, io, cd, acc),
                 PEAK_BF16 if cd == torch.bfloat16 else PEAK_F32)


def randn(shape, gen, scale=1.0, dtype=torch.float32, device="cuda"):
    return (torch.randn(shape, generator=gen) * scale).to(device=device,
                                                          dtype=dtype)


def _forward_route(dims, cd, io, residual) -> tuple:
    """The forward's route for a chain as its planner picks it: (name, tile
    rows); "mma" (bf16 tensor cores), "f32_tiles" (f32 on f32_tile_gemm),
    "f32_wide" (fused_ff_fwd_kernel on block_gemm, chains too wide for
    f32_tiles) or "none" (no tile fits), which its launcher's Python
    mirror, ``forward_tile_rows``, must give too (a ValueError there for
    "none")."""
    import ctypes

    from resolution_pde_tpu_torch.ops.kernels import _build, fused_ff

    rows = (ctypes.c_int * 1)()
    route = _build.library().rpde_fused_ff_forward_route(
        int(cd == torch.bfloat16), int(io == torch.bfloat16), int(residual),
        (ctypes.c_int * len(dims))(*dims), len(dims) - 1, rows)
    names = {0: "none", 1: "mma", 2: "f32_tiles", 3: "f32_wide"}
    got = names[route], rows[0]
    try:
        want = fused_ff.forward_tile_rows(dims, True, residual, cd, io)
    except ValueError:
        want = ("none", 0)
    require(got == want, f"K1f planner for {dims} {cd} io {io} residual "
            f"{residual}: {got}, its mirror {want}")
    return got


def check_fused_ff(gen) -> tuple:
    """K1f against its plain forward. Returns the bf16 (tensor cores) and
    f32 (CUDA cores) records at the train shape."""
    from resolution_pde_tpu_torch.ops.kernels import fused_ff

    def case(n, dims, *, ln, residual, approx, dtype, tol, label, save=False,
             io=None, route=None, repeat=False):
        # io: the type of x, the residual and the output (dtype if None);
        # route: the planner's route the chain must take; repeat: a second
        # call on the same inputs must give the same bits
        io = io or dtype
        took, tile_rows = _forward_route(dims, dtype, io, residual)
        require(took != "none" and (route is None or took == route),
                f"K1f {label}: route {took}, expected {route}")
        ks = [randn((dims[i], dims[i + 1]), gen, dims[i] ** -0.5)
              for i in range(len(dims) - 1)]
        bs = [randn((d,), gen, 0.1) for d in dims[1:]]
        lnp = (1.0 + randn((dims[-1],), gen, 0.1),
               randn((dims[-1],), gen, 0.1)) if ln else None
        x = randn((n, dims[0]), gen, dtype=io)
        res = randn((n, dims[-1]), gen, dtype=io) if residual else None
        kw = dict(approx_gelu=approx, compute_dtype=dtype)
        extra = {}
        if save:
            got, zs = fused_ff.fused_feedforward_fwd(x, ks, bs, lnp, res,
                                                     save_acts=True, **kw)
            ref, zs_ref = fused_ff.fused_feedforward_reference(
                x, ks, bs, lnp, res, save_acts=True, **kw)
            zerr = rel_l2(zs, torch.cat(zs_ref, dim=1))
            extra = dict(zs_rel_l2=f"{zerr:.3e}")
            require(zerr <= tol, f"K1f {label}: saved pre-activations "
                    f"rel_l2 {zerr} > {tol}")
        else:
            got = fused_ff.fused_feedforward(x, ks, bs, lnp, res, **kw)
            ref = fused_ff.fused_feedforward_reference(x, ks, bs, lnp, res,
                                                       **kw)
        torch.cuda.synchronize()
        err, mx = rel_l2(got, ref), max_abs(got, ref)
        ms = time_ms(lambda: fused_ff.fused_feedforward(x, ks, bs, lnp, res,
                                                        **kw))
        plain = time_ms(lambda: fused_ff.fused_feedforward_reference(
            x, ks, bs, lnp, res, **kw))
        cost = _ff_cost(n, dims, ln, residual, dtype, 1)
        log("K1", case=label, rows=n, dims="->".join(map(str, dims)),
            route=took, tile_rows=tile_rows, rel_l2=f"{err:.3e}",
            max_abs=f"{mx:.3e}", tol=tol, ms=f"{ms:.4f}",
            plain_ms=f"{plain:.4f}", bound_ms=f"{cost['bound_ms']:.4f}",
            **extra)
        require(bool(torch.isfinite(got.float()).all()) and err <= tol,
                f"K1 {label}: rel_l2 {err} > {tol}")
        if repeat:
            again = fused_ff.fused_feedforward(x, ks, bs, lnp, res, **kw)
            same = bool(torch.equal(got, again))
            log("K1", case=f"{label}_repeat", bit_equal=same)
            require(same, f"K1 {label}: two calls on the same inputs differ")
        return dict(max_abs_err=mx, ms=ms, plain_ms=plain, **cost)

    hidden = WIDTH * FACTOR
    dims = [WIDTH] + [hidden] * (FF_LAYERS - 1) + [WIDTH]
    ragged = [24, 40, 40, 24]
    # bf16 (tensor cores): the products of bf16 values are exact in f32 in
    # both, so only the order of the f32 sums differs; a rounding flip of a
    # bf16 hidden activation or of the output then moves an element by up
    # to one bf16 ulp (2^-8 relative)
    bf16 = case(BATCH * RES * RES, dims, ln=True, residual=True, approx=True,
                dtype=torch.bfloat16, tol=1e-2, label="train_bf16")
    # widths and rows that no fragment or tile divides: the zero-filled
    # fragments, the masked stores, one layer, the exact GELU and the
    # saved pre-activations
    case(1000, ragged, ln=False, residual=False, approx=False,
         dtype=torch.bfloat16, tol=1e-2, label="ragged_bf16")
    case(1000, ragged[:2], ln=True, residual=True, approx=True,
         dtype=torch.bfloat16, tol=1e-2, label="ragged_bf16_ln_res_1layer")
    case(1000, ragged, ln=True, residual=True, approx=True,
         dtype=torch.bfloat16, tol=1e-2, label="ragged_bf16_saved", save=True)
    # f32 x, residual and output with bf16 products: x rounded to bf16 as
    # it is loaded, the f32 residual staged and the f32 stores
    case(1000, ragged, ln=True, residual=True, approx=True,
         dtype=torch.bfloat16, tol=1e-2, label="ragged_bf16_f32_io",
         io=torch.float32)
    # f32 (CUDA cores, f32_tile_gemm): IEEE f32 products in both, only the
    # order of the sums differs; over the train shape's 256-term sums hence
    # 1e-4 there. Ragged: rows and widths no tile divides, widths no
    # multiple of 4 (the weights' zero padding), the saved pre-activations,
    # bf16 x, residual and output (a rounding flip of an output moves it by
    # one bf16 ulp)
    f32t = "f32_tiles"
    case(1000, ragged, ln=False, residual=False, approx=False,
         dtype=torch.float32, tol=1e-5, label="ragged_f32", route=f32t)
    case(1003, [30, 50, 50, 30], ln=True, residual=True, approx=True,
         dtype=torch.float32, tol=1e-5, label="ragged30_f32_ln_res",
         route=f32t)
    case(1000, ragged, ln=True, residual=True, approx=True,
         dtype=torch.float32, tol=1e-5, label="ragged_f32_saved", save=True,
         route=f32t)
    case(1000, ragged[:2], ln=True, residual=True, approx=False,
         dtype=torch.float32, tol=1e-5, label="ragged_f32_ln_res_1layer",
         route=f32t)
    case(1000, ragged, ln=True, residual=True, approx=True,
         dtype=torch.float32, tol=1e-2, label="ragged_f32_bf16_io",
         io=torch.bfloat16, route=f32t)
    # factor-4 chains wider than the train shape's (hidden layers in column
    # chunks of 256, shorter tiles), with the saved pre-activations too;
    # and a chain too wide for 8 rows of both buffers, on fused_ff_fwd_kernel
    for w in (160, 192, 256):
        for save in (False, True):
            case(2003, [w, 4 * w, 4 * w, w], ln=True, residual=True,
                 approx=True, dtype=torch.float32, tol=1e-5,
                 label=f"width{w}_f32" + ("_saved" if save else ""),
                 save=save, route=f32t)
    case(301, [64, 3072, 64], ln=True, residual=True, approx=True,
         dtype=torch.float32, tol=1e-5, label="hidden3072_f32",
         route="f32_wide")
    f32 = case(BATCH * RES * RES, dims, ln=True, residual=True, approx=True,
               dtype=torch.float32, tol=1e-4, label="train_f32", route=f32t,
               repeat=True)
    # f32 at FFNO1D's chain (ffno_1d.yaml: width WIDE, exact GELU,
    # LayerNorm, the residual outside) on its train batch's rows
    ffno1d = case(S4_BATCH * KS_RES, FFNO1D_CHAIN, ln=True, residual=False,
                  approx=False, dtype=torch.float32, tol=1e-5,
                  label=f"ffno1d_w{WIDE}_f32", route=f32t, repeat=True)
    f32.update({f"ffno1d_{k}": v for k, v in ffno1d.items()})
    # bf16 at the chain run_wide's model runs (width WIDE), at its rows
    case(BATCH * RES * RES, [WIDE] + [WIDE * FACTOR] * (FF_LAYERS - 1)
         + [WIDE], ln=True, residual=True, approx=True, dtype=torch.bfloat16,
         tol=1e-2, label=f"width{WIDE}_bf16", route="mma")
    # the factor-4 chain at width 512: bf16 on 16-row tiles (its thin warp
    # tiles; no 32-row tile's buffers fit beside the ring), f32 on 8-row
    # tiles, with LayerNorm and residual and the saved pre-activations
    for dtype, tol, route in ((torch.bfloat16, 1e-2, "mma"),
                              (torch.float32, 1e-5, f32t)):
        for save in (False, True):
            case(4096, [512, 2048, 2048, 512], ln=True, residual=True,
                 approx=True, dtype=dtype, tol=tol,
                 label=f"width512_{str(dtype)[6:]}"
                 + ("_saved" if save else ""), save=save, route=route)
    return bf16, f32


def _backward_tile_rows(dims, cd, has_ln=True) -> int:
    """K1b's tile rows for a chain from the kernel's planner, which its
    launcher's Python mirror must give too (-1: refused, a ValueError
    there)."""
    import ctypes

    from resolution_pde_tpu_torch.ops.kernels import _build, fused_ff

    got = _build.library().rpde_fused_ff_backward_tile_rows(
        int(cd == torch.bfloat16), (ctypes.c_int * len(dims))(*dims),
        len(dims) - 1, int(has_ln))
    try:
        want = fused_ff.backward_tile_rows(dims, has_ln, cd)
    except ValueError:
        want = -1
    require(got == want, f"K1b planner for {dims} {cd}: {got} rows, its "
            f"mirror {want}")
    return got


def check_planner_mirrors() -> None:
    """The launchers' Python mirrors of the kernels' planners, which pick
    routes and refuse shapes before any launch, against the planners
    themselves: the staged route's fit over a grid of shapes, and K1b's
    tile rows over chains in both precisions."""
    from resolution_pde_tpu_torch.ops.kernels import _build
    from resolution_pde_tpu_torch.ops.kernels import spectral_mix as sm

    lib = _build.library()
    shapes = [(n, m, c, o)
              for n in (16, 40, 64, 128, 256, 512, 832, 840)
              for m in (8, 17, 33, 64, 80)
              for c in (8, 24, 64, 96, 104, 112, 128, 136, 256)
              for o in (8, 24, 64, 96, 104, 112, 128, 136, 256)]
    # the staged route's limit, its grid's modes, at its edge too
    staged = shapes + [(256, 65535, 8, 8), (256, 65536, 8, 8)]
    bad = [s for s in staged
           if bool(lib.rpde_spectral_staged_fits(*s)) != sm.staged_fits(*s)]
    log("mirrors", case="staged_fits", shapes=len(staged),
        fit=sum(sm.staged_fits(*s) for s in staged), disagree=len(bad))
    require(not bad, f"staged_fits disagrees with the library at {bad[:5]}")
    chains = 0
    for w in (8, 24, 30, 64, 96, 128, 160, 192, 224, 256, 288, 320, 384, 512,
              640):
        for factor in (1, 2, 4):
            for layers in (1, 2, 3):
                dims = [w] + [factor * w] * (layers - 1) + [w]
                for cd in (torch.float32, torch.bfloat16):
                    for has_ln in (True, False):
                        _backward_tile_rows(dims, cd, has_ln)
                        chains += 1
    log("mirrors", case="k1b_plan", chains=chains, disagree=0)
    # K1f: the bench chain, width 128's, the factor-4 chains at 320 and
    # 512, a ragged chain and the first bf16 factor-4 chains no tile fits
    # (837 wide with bf16 x, residual and output; 833 with f32 ones), in
    # both compute types, both io types, with and without the residual
    fwd = [[WIDTH, 4 * WIDTH, 4 * WIDTH, WIDTH],
           [WIDE, 4 * WIDE, 4 * WIDE, WIDE], [320, 1280, 1280, 320],
           [512, 2048, 2048, 512], [30, 50, 50, 30],
           [833, 3332, 3332, 833], [837, 3348, 3348, 837]]
    plans = {}
    for dims in fwd:
        for cd in (torch.bfloat16, torch.float32):
            for io in (torch.bfloat16, torch.float32):
                for residual in (True, False):
                    plans[(dims[0], str(cd)[6:], str(io)[6:], residual)] = \
                        _forward_route(dims, cd, io, residual)
    log("mirrors", case="k1f_plan", chains=len(plans), disagree=0,
        **{f"w{w}_{cd}_io_{io}" + ("_res" if r else ""): f"{p[0]}:{p[1]}"
           for (w, cd, io, r), p in plans.items() if r})
    require(plans[(837, "bfloat16", "bfloat16", True)][0] == "none"
            and plans[(833, "bfloat16", "float32", True)][0] == "none"
            and plans[(833, "bfloat16", "bfloat16", True)][0] == "mma",
            "K1f bf16: the widest factor-4 chains moved")
    # the launcher refuses such a chain with a ValueError before any launch
    from resolution_pde_tpu_torch.ops.kernels import fused_ff
    dims = [837, 3348, 3348, 837]
    ks = [torch.zeros((a, b), device="cuda") for a, b in zip(dims, dims[1:])]
    bs = [torch.zeros((b,), device="cuda") for b in dims[1:]]
    x = torch.zeros((16, dims[0]), device="cuda", dtype=torch.bfloat16)
    try:
        fused_ff.fused_feedforward_fwd(x, ks, bs, None, x[:, :dims[-1]])
        refused = False
    except ValueError as e:
        refused = "837" in str(e)
    log("mirrors", case="k1f_refuses", dims="->".join(map(str, dims)),
        value_error=refused)
    require(refused, "K1f bf16: the chain no tile fits was not refused "
            "with a ValueError")


def check_fused_ff_bwd(gen) -> tuple:
    """K1b against its plain backward. Returns the bf16 (tensor cores) and
    f32 (CUDA cores) records at the train shape, the bf16 one with the
    saved-pre-activation variant's time, plain time and bound beside it."""
    from resolution_pde_tpu_torch.ops.kernels import fused_ff

    def case(n, dims, *, ln, approx, dtype, tol, label, save=False,
             io=None, repeat=False):
        # io: the type of x, g and dx (dtype if None); repeat: a second
        # call on the same inputs must give the same bits
        io = io or dtype
        tile_rows = _backward_tile_rows(dims, dtype, ln)
        ks = [randn((dims[i], dims[i + 1]), gen, dims[i] ** -0.5)
              for i in range(len(dims) - 1)]
        bs = [randn((d,), gen, 0.1) for d in dims[1:]]
        lnp = (1.0 + randn((dims[-1],), gen, 0.1),
               randn((dims[-1],), gen, 0.1)) if ln else None
        x = randn((n, dims[0]), gen, dtype=io)
        g = randn((n, dims[-1]), gen, dtype=io)
        kw = dict(approx_gelu=approx, compute_dtype=dtype)
        zs, zs_ref = None, None
        if save:
            _, zs_ref = fused_ff.fused_feedforward_reference(
                x, ks, bs, lnp, save_acts=True, **kw)
            _, zs = fused_ff.fused_feedforward_fwd(x, ks, bs, lnp,
                                                   save_acts=True, **kw)
            err = rel_l2(zs, torch.cat(zs_ref, dim=1))
            require(err <= tol, f"K1 saved pre-activations {label}: {err}")
        got = fused_ff.fused_feedforward_bwd(x, g, ks, bs, lnp, zs_saved=zs,
                                             **kw)
        ref = fused_ff.fused_feedforward_bwd_reference(x, g, ks, bs, lnp,
                                                       zs_saved=zs_ref, **kw)
        torch.cuda.synchronize()
        names = (["dx"] + [f"dW{i}" for i in range(len(ks))]
                 + [f"db{i}" for i in range(len(bs))]
                 + (["dln_scale", "dln_bias"] if ln else []))
        flat = lambda r: [r[0], *r[1], *r[2], *(r[3] or ())]  # noqa: E731
        errs = {k: rel_l2(a, b) for k, a, b in zip(names, flat(got),
                                                    flat(ref))}
        mx = max(max_abs(a, b) for a, b in zip(flat(got), flat(ref)))
        ms = time_ms(lambda: fused_ff.fused_feedforward_bwd(
            x, g, ks, bs, lnp, zs_saved=zs, **kw), reps=10)
        plain = time_ms(lambda: fused_ff.fused_feedforward_bwd_reference(
            x, g, ks, bs, lnp, zs_saved=zs_ref, **kw), reps=10)
        log("K1b", case=label, rows=n, dims="->".join(map(str, dims)),
            route="mma" if dtype == torch.bfloat16 else "f32_tiles",
            tile_rows=tile_rows, rel_l2=",".join(f"{k}:{v:.3e}" for k, v in errs.items()),
            max_abs=f"{mx:.3e}", tol=tol, ms=f"{ms:.4f}",
            plain_ms=f"{plain:.4f}")
        require(all(bool(torch.isfinite(a.float()).all()) for a in flat(got)),
                f"K1b {label}: non-finite gradient")
        bad = {k: v for k, v in errs.items() if not v <= tol}
        require(not bad, f"K1b {label}: rel_l2 above {tol}: {bad}")
        if repeat:
            again = fused_ff.fused_feedforward_bwd(x, g, ks, bs, lnp,
                                                   zs_saved=zs, **kw)
            same = all(bool(torch.equal(a, b))
                       for a, b in zip(flat(got), flat(again)))
            log("K1b", case=f"{label}_repeat", bit_equal=same)
            require(same, f"K1b {label}: two calls on the same inputs differ")
        saved = zs.shape[1] if save else 0
        return dict(max_abs_err=mx, ms=ms, plain_ms=plain,
                    **_ff_cost(n, dims, ln, False, dtype, 2 if save else 3,
                               saved))

    hidden = WIDTH * FACTOR
    dims = [WIDTH] + [hidden] * (FF_LAYERS - 1) + [WIDTH]
    ragged = [24, 40, 40, 24]
    # bf16 (tensor cores): the products of bf16 values are exact in f32 in
    # both, so dW, db and dLN differ only in the order of their f32 sums;
    # a sum-order flip of a value rounded to bf16 (dx, a dz, a hidden h)
    # moves it by one bf16 ulp (2^-8 relative)
    bench = case(BATCH * RES * RES, dims, ln=True, approx=True,
                 dtype=torch.bfloat16, tol=1e-2, label="train_bf16")
    # widths and rows that no fragment or tile divides: the zero-filled
    # fragments and the masked stores
    case(1000, ragged, ln=False, approx=False, dtype=torch.bfloat16,
         tol=1e-2, label="ragged_bf16")
    case(1000, ragged[:2], ln=True, approx=True, dtype=torch.bfloat16,
         tol=1e-2, label="ragged_bf16_ln_1layer")
    # f32 (CUDA cores): only the order of the f32 sums differs; over the
    # 524,288 rows of the train shape the sums are long, hence 1e-4 there
    case(1000, ragged, ln=False, approx=False, dtype=torch.float32, tol=1e-5,
         label="ragged_f32")
    # widths no multiple of 4 (the weights' zero padding, the masked
    # columns), one layer with LayerNorm, and bf16 x, g and dx
    case(1000, [30, 50, 50, 30], ln=True, approx=True, dtype=torch.float32,
         tol=1e-5, label="ragged30_f32_ln")
    case(1000, ragged[:2], ln=True, approx=True, dtype=torch.float32,
         tol=1e-5, label="ragged_f32_ln_1layer")
    case(1000, ragged, ln=False, approx=False, dtype=torch.float32,
         tol=1e-2, label="ragged_f32_bf16_io", io=torch.bfloat16)
    f32 = case(BATCH * RES * RES, dims, ln=True, approx=True,
               dtype=torch.float32, tol=1e-4, label="train_f32", repeat=True)
    # factor-4 chains wider than the train shape's: their middle layers run
    # in column chunks of 256, shorter tiles (each case logs the planner's
    # tile rows, checked against its Python mirror), recomputed and with
    # saved pre-activations
    for w in (160, 192, 256):
        for save in (False, True):
            case(2003, [w, 4 * w, 4 * w, w], ln=True, approx=True,
                 dtype=torch.float32, tol=1e-5,
                 label=f"width{w}_f32" + ("_saved" if save else ""),
                 save=save)
    saved = case(BATCH * RES * RES, dims, ln=True, approx=True,
                 dtype=torch.bfloat16, tol=1e-2, label="saved_bf16", save=True)
    # factor-4 chains past width 256, whose pre-activations the kernel
    # keeps in device memory (the least tile does not fit beside them)
    for w in (320, 512):
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            for save in (False, True):
                case(2003, [w, 4 * w, 4 * w, w], ln=True, approx=True,
                     dtype=dtype, tol=tol,
                     label=f"width{w}_{str(dtype)[6:]}"
                     + ("_saved" if save else ""), save=save)
    # f32 at FFNO1D's chain on its train batch's rows, recomputed (its
    # route, ff_impl 'fused')
    ffno1d = case(S4_BATCH * KS_RES, FFNO1D_CHAIN, ln=True, approx=False,
                  dtype=torch.float32, tol=1e-5,
                  label=f"ffno1d_w{WIDE}_f32", repeat=True)
    f32.update({f"ffno1d_{k}": v for k, v in ffno1d.items()})
    # bf16 at the chain run_wide's model runs (width WIDE), at its rows,
    # recomputed and with saved pre-activations
    wide = [WIDE] + [WIDE * FACTOR] * (FF_LAYERS - 1) + [WIDE]
    for save in (False, True):
        case(BATCH * RES * RES, wide, ln=True, approx=True,
             dtype=torch.bfloat16, tol=1e-2,
             label=f"width{WIDE}_bf16" + ("_saved" if save else ""),
             save=save)
    bench.update(saved_ms=saved["ms"], saved_plain_ms=saved["plain_ms"],
                 saved_bound_ms=saved["bound_ms"],
                 saved_bound_by=saved["bound_by"])
    return bench, f32


def _staged_floor(rows, n, c, o, m, io, acc=False) -> float:
    """The staged route's own byte floor (ms): the function's bytes
    (``_pass_cost``) and its spectra and mixed spectra, (m, rows, 2 C8)
    and (m, rows, 2 O8) in bf16, each written once and read once."""
    e = torch.finfo(io).bits // 8
    c8, o8 = -(-c // 8) * 8, -(-o // 8) * 8
    nbytes = (rows * n * (c + o * (2 if acc else 1)) * e
              + (2 * n * 2 * m + m * 2 * c * o) * 2
              + 2 * m * rows * 2 * (c8 + o8) * 2)
    return nbytes / HBM_BYTES_S * 1e3


def spectral_case(gen, shape, c_out, axis, cd, tol, label, *, io=None,
                  acc=False, adjoint=False, timed=False, route=None,
                  modes=MODES) -> dict:
    """One axis pass (``adjoint``: its adjoint) of a channels-last (B, H, W,
    C) tensor along ``axis`` to ``c_out`` channels with m = min(modes,
    n // 2 + 1), added into a random ``acc`` when asked, against the plain
    version on the same inputs on the card; timed beside it when
    ``timed``. ``route``: the kernel the shape must take ("staged" or
    "cuda_cores", spectral_route): a launch on the staged route shows
    in the wide count, and an f32 pass makes one K3 launch a chunk of
    ``f32_chunk_plan``."""
    from resolution_pde_tpu_torch.ops.kernels import spectral_mix as sm

    cuda = torch.device("cuda")
    c, n = shape[3], shape[axis]
    m = min(modes, n // 2 + 1)
    took = sm.spectral_route(cd, n, m, c, c_out)
    require(route is None or took == route,
            f"K2 {label}: route {took}, expected {route}")
    wide0, k30 = sm.wide_launches, sm.k3_launches
    x = randn(shape, gen, dtype=io or cd)
    if adjoint:  # the pass maps c_out channels to c; its adjoint c to c_out
        wab = sm.mix_blocks(randn((c_out, c, modes, 2), gen, 0.1), m)
        f2, i2 = sm.adjoint_factors(n, m, "ortho", cuda)
        plain_w = sm.pack_blocks(wab).transpose(1, 2)
        run = sm.spectral_axis_adjoint
    else:
        wab = sm.mix_blocks(randn((c, c_out, modes, 2), gen, 0.1), m)
        f2, i2 = sm.packed_factors(n, m, "ortho", cuda)
        plain_w = sm.pack_blocks(wab)
        run = sm.spectral_axis_pass
    out_shape = (*shape[:3], c_out)
    acc0 = randn(out_shape, gen, dtype=x.dtype) if acc else None
    got = run(x, wab, axis, "ortho", cd, acc=acc0.clone() if acc else None)
    ref = sm._plain_axis_pass(x, f2, i2, plain_w, axis, cd,
                              acc0.clone() if acc else None)
    torch.cuda.synchronize()
    wide, k3 = sm.wide_launches - wide0, sm.k3_launches - k30
    require(wide == int(took == "staged"),
            f"K2 {label}: {wide} launches on the staged route, route {took}")
    chunks = (len(sm.f32_chunk_plan(m, c, c_out)) if took == "cuda_cores"
              else 0)
    require(k3 == chunks, f"K3 {label}: {k3} launches, its chunk plan "
            f"{chunks}")
    err, mx = rel_l2(got, ref), max_abs(got, ref)
    fields = dict(case=label, shape="x".join(map(str, shape)), axis=axis,
                  C=c, O=c_out, m=m, acc=int(acc), route=took,
                  rel_l2=f"{err:.3e}", max_abs=f"{mx:.3e}", tol=tol)
    if chunks:
        fields.update(k3_launches=k3)
    res = dict(max_abs_err=mx)
    if timed:
        buf = acc0.clone() if acc else None
        ms = time_ms(lambda: run(x, wab, axis, "ortho", cd, acc=buf))
        plain = time_ms(lambda: sm._plain_axis_pass(x, f2, i2, plain_w, axis,
                                                    cd, buf))
        res.update(ms=ms, plain_ms=plain,
                   **_pass_cost(x.numel() // (n * c), n, c, c_out, m,
                                x.dtype, cd, acc))
        fields.update(ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
                      bound_ms=f"{res['bound_ms']:.4f}")
        if took == "staged":
            res["staged_floor_ms"] = _staged_floor(
                x.numel() // (n * c), n, c, c_out, m, x.dtype, acc)
            fields.update(staged_floor_ms=f"{res['staged_floor_ms']:.4f}")
    log("K2adj" if adjoint else "K2", **fields)
    require(got.shape == out_shape and bool(torch.isfinite(got.float()).all())
            and err <= tol, f"K2 {label}: rel_l2 {err} > {tol}")
    return res


def _with_h(w_pass: dict, h_pass: dict) -> dict:
    """The W pass's entry with the H pass's (acc) time, plain time and
    bound (and the staged route's floor) beside it."""
    rec = dict(w_pass, h_acc_ms=h_pass["ms"], h_acc_plain_ms=h_pass["plain_ms"],
               h_acc_bound_ms=h_pass["bound_ms"])
    if "staged_floor_ms" in h_pass:
        rec["h_acc_staged_floor_ms"] = h_pass["staged_floor_ms"]
    return rec


def check_spectral(gen) -> tuple:
    from resolution_pde_tpu_torch.ops.kernels import spectral_mix as sm

    train = (BATCH, RES, RES, WIDTH)
    bf, f32 = torch.bfloat16, torch.float32
    # bf16 (the staged route): intermediates are rounded to bf16 in both; a
    # rounding flip moves an element by up to one bf16 ulp. The train
    # shape's two passes: W, and H read in place and added into acc
    w16 = spectral_case(gen, train, WIDTH, 2, bf, 1e-2, "train_w_bf16",
                        timed=True, route="staged")
    h16 = spectral_case(gen, train, WIDTH, 1, bf, 1e-2, "train_h_acc_bf16",
                        acc=True, timed=True, route="staged")
    # ragged shapes: n = 32 (m = 17), n = 40 (not a multiple of 16), C = 24
    # -> O = 40 (the H pass, acc), bf16 products with f32 x and out
    spectral_case(gen, (4, 16, 32, WIDTH), WIDTH, 2, bf, 1e-2, "n32_m17")
    spectral_case(gen, (4, 16, 40, WIDTH), WIDTH, 2, bf, 1e-2, "n40")
    spectral_case(gen, (4, 40, 32, 24), 40, 1, bf, 1e-2, "c24_o40_h_acc",
                  acc=True)
    spectral_case(gen, (4, 16, 64, WIDTH), WIDTH, 2, bf, 1e-2,
                  "f32_io_bf16_products", io=f32)
    # odd channel counts: x staged through registers, out stored a channel
    # at a time
    spectral_case(gen, (2, 8, 20, 5), 3, 2, bf, 1e-2, "c5_o3")
    # f32 mode (K3): IEEE f32 products in both, only the sum order differs.
    # The train shape's two passes, W and H read in place and added into acc
    k3 = spectral_case(gen, train, WIDTH, 2, f32, 1e-4, "train_w_f32",
                       timed=True)
    k3h = spectral_case(gen, train, WIDTH, 1, f32, 1e-4, "train_h_acc_f32",
                        acc=True, timed=True)
    # ragged shapes of the f32 kernel: n = 32 (m = 17), n = 40, C = 24 ->
    # O = 40 along H with acc, C = 5 -> O = 3 (x staged through registers,
    # out a channel a store), bf16 x and out with f32 products (a bf16
    # rounding flip of an output moves it by one bf16 ulp)
    spectral_case(gen, (4, 16, 32, WIDTH), WIDTH, 2, f32, 1e-4, "n32_m17_f32")
    spectral_case(gen, (4, 16, 40, WIDTH), WIDTH, 2, f32, 1e-4, "n40_f32")
    spectral_case(gen, (4, 40, 32, 24), 40, 1, f32, 1e-4, "c24_o40_h_acc_f32",
                  acc=True)
    spectral_case(gen, (2, 8, 20, 5), 3, 2, f32, 1e-4, "c5_o3_f32")
    spectral_case(gen, (4, 16, 64, WIDTH), WIDTH, 2, f32, 1e-4,
                  "bf16_io_f32_products", io=bf)
    # wider channels, in tiles of fewer rows: 128 -> 128 at the train
    # shape's 2048 rows of 256 points (m = 64; the width of
    # configs/model/ffno_1d.yaml; 2 rows a tile), timed;
    # 96 -> 128 along H with acc (2 rows); 200 -> 136 (1 row)
    spectral_case(gen, (BATCH, RES, RES, 128), 128, 2, f32, 1e-4,
                  "c128_o128_f32", timed=True)
    spectral_case(gen, (2, 64, 48, 96), 128, 1, f32, 1e-4,
                  "c96_o128_h_acc_f32", acc=True)
    spectral_case(gen, (2, 8, 128, 200), 136, 2, f32, 1e-4, "c200_o136_f32")
    # f32 passes beyond one launch of K3, in chunks of at most 64 modes and
    # 256 channels (two of modes at m = 80; two of input channels at 264),
    # the later chunks added through accumulate: only the order of the f32
    # sums differs
    spectral_case(gen, (2, 8, 160, 16), 24, 2, f32, 1e-4, "m80_f32_chunks",
                  modes=80, route="cuda_cores")
    spectral_case(gen, (2, 8, 24, 264), 72, 1, f32, 1e-4,
                  "c264_o72_h_acc_f32_chunks", acc=True, route="cuda_cores")
    # the same with bf16 x and out: each added chunk rounds the output
    # slice to bf16 once more, so the bf16 tolerance
    spectral_case(gen, (2, 8, 24, 264), 72, 1, f32, 1e-2,
                  "c264_o72_h_acc_bf16_io_f32_chunks", io=bf, acc=True,
                  route="cuda_cores")
    # bf16 passes at wider shapes, which no fused kernel's tile holds: 128
    # -> 128 at the train shape's 2048 rows of 256 points (FFNO2D at width
    # 128), W and H with acc, 256 -> 256, m = 72 at n = 160, 264 -> 200
    # along H with acc, and f32 x and out; bf16 tolerance
    wide = spectral_case(gen, (BATCH, RES, RES, 128), 128, 2, bf, 1e-2,
                         "c128_o128_bf16_staged", timed=True, route="staged")
    wide_h = spectral_case(gen, (BATCH, RES, RES, 128), 128, 1, bf, 1e-2,
                           "c128_o128_h_acc_bf16_staged", acc=True,
                           timed=True, route="staged")
    spectral_case(gen, (2, 32, RES, 256), 256, 2, bf, 1e-2,
                  "c256_o256_bf16_staged", timed=True, route="staged")
    spectral_case(gen, (2, 8, 160, 136), 136, 2, bf, 1e-2,
                  "m72_n160_bf16_staged", modes=72, route="staged")
    spectral_case(gen, (2, 8, 24, 264), 200, 1, bf, 1e-2,
                  "c264_o200_h_acc_bf16_staged", acc=True, route="staged")
    spectral_case(gen, (2, 8, RES, 112), 112, 2, bf, 1e-2,
                  "c112_o112_f32_io_bf16_staged", io=f32, route="staged")
    # channel counts no multiple of 8: x read through registers, the
    # inverse's stores from its fragments (f32 out two channels a store,
    # bf16 out with an odd O one at a time), the mix's -b fragments past
    # a boundary at 120 rows
    spectral_case(gen, (2, 8, 40, 117), 131, 1, bf, 1e-2,
                  "c117_o131_h_acc_f32_io_bf16_staged", io=f32, acc=True,
                  route="staged")
    spectral_case(gen, (2, 8, 40, 117), 131, 2, bf, 1e-2,
                  "c117_o131_bf16_staged", route="staged")
    spectral_case(gen, (2, 8, RES, 104), 104, 2, bf, 1e-2, "c104_o104_bf16",
                  route="staged")
    x = randn((BATCH, RES, RES, 128), gen, dtype=bf)
    wab = sm.mix_blocks(randn((128, 128, MODES, 2), gen, 0.1), MODES)
    first = sm.spectral_axis_pass(x, wab, 2, "ortho", bf)
    again = sm.spectral_axis_pass(x, wab, 2, "ortho", bf)
    same = bool(torch.equal(first, again))
    log("K2", case="c128_o128_bf16_staged_repeat", bit_equal=same)
    require(same, "K2 staged: two calls on the same inputs differ")
    # two calls on the same inputs give the same bits (sums in an order
    # fixed by the shapes)
    x = randn(train, gen)
    wab = sm.mix_blocks(randn((WIDTH, WIDTH, MODES, 2), gen, 0.1), MODES)
    first = sm.spectral_axis_pass(x, wab, 2, "ortho", f32)
    again = sm.spectral_axis_pass(x, wab, 2, "ortho", f32)
    same = bool(torch.equal(first, again))
    log("K2", case="train_w_f32_repeat", bit_equal=same)
    require(same, "K3: two calls on the same inputs differ")

    # both axes at W = 64 (m = 33) and H = 48 (m = 25): the H pass reads the
    # channels-last tensor in place and adds into the W pass's output
    x = randn((BATCH, 48, 64, WIDTH), gen, dtype=torch.bfloat16)
    wy = randn((WIDTH, WIDTH, MODES, 2), gen, 0.1)
    wx = randn((WIDTH, WIDTH, MODES, 2), gen, 0.1)
    got = sm.factorized_spectral_conv_2d_pallas2(x, wy, wx, MODES)
    ref = sm.factorized_spectral_conv_2d_pallas2(x.cpu(), wy.cpu(),
                                                 wx.cpu(), MODES)
    err = rel_l2(got.cpu(), ref)
    log("K2", case="both_axes_bf16", shape="8x48x64x64", m="25/33",
        rel_l2=f"{err:.3e}", tol=1e-2)
    require(err <= 1e-2, f"K2 both axes: rel_l2 {err}")
    return _with_h(w16, h16), _with_h(k3, k3h), _with_h(wide, wide_h)


def check_spectral_adjoint(gen) -> tuple:
    from resolution_pde_tpu_torch.ops.kernels import spectral_mix as sm

    train = (BATCH, RES, RES, WIDTH)
    bf, f32 = torch.bfloat16, torch.float32
    # as the forward pass: bf16 intermediates rounded in both, a flip moves
    # an element by one bf16 ulp; f32 differs only in the order of sums.
    # The backward's two adjoints: W, and H added into it
    w16 = spectral_case(gen, train, WIDTH, 2, bf, 1e-2, "train_w_bf16",
                        adjoint=True, timed=True, route="staged")
    h16 = spectral_case(gen, train, WIDTH, 1, bf, 1e-2, "train_h_acc_bf16",
                        acc=True, adjoint=True, timed=True, route="staged")
    spectral_case(gen, (4, 16, 48, 40), 24, 2, bf, 1e-2, "o40_to_c24",
                  adjoint=True)
    k3 = spectral_case(gen, train, WIDTH, 2, f32, 1e-4, "train_w_f32",
                       adjoint=True, timed=True)
    k3h = spectral_case(gen, train, WIDTH, 1, f32, 1e-4, "train_h_acc_f32",
                        acc=True, adjoint=True, timed=True)
    spectral_case(gen, (4, 16, 48, 40), 24, 2, f32, 1e-4, "o40_to_c24_f32",
                  adjoint=True)
    spectral_case(gen, (2, 8, 128, 136), 200, 2, f32, 1e-4,
                  "o136_to_c200_f32", adjoint=True)
    # the f32 adjoint in chunks: m = 80, and 72 -> 264 (two output slices)
    spectral_case(gen, (2, 8, 160, 24), 16, 2, f32, 1e-4,
                  "m80_f32_chunks", adjoint=True, modes=80,
                  route="cuda_cores")
    spectral_case(gen, (2, 8, 24, 72), 264, 2, f32, 1e-4,
                  "o72_to_c264_f32_chunks", adjoint=True, route="cuda_cores")
    # the bf16 adjoint at wider shapes: 128 -> 128 at the train shape's
    # rows (W, and H with acc), 256 -> 256 and m = 72
    wide = spectral_case(gen, (BATCH, RES, RES, 128), 128, 2, bf, 1e-2,
                         "c128_o128_bf16_staged", adjoint=True, timed=True,
                         route="staged")
    wide_h = spectral_case(gen, (BATCH, RES, RES, 128), 128, 1, bf, 1e-2,
                           "c128_o128_h_acc_bf16_staged", acc=True,
                           adjoint=True, timed=True, route="staged")
    spectral_case(gen, (2, 32, RES, 256), 256, 2, bf, 1e-2,
                  "c256_o256_bf16_staged", adjoint=True, timed=True,
                  route="staged")
    spectral_case(gen, (2, 8, 160, 136), 136, 2, bf, 1e-2,
                  "m72_n160_bf16_staged", adjoint=True, modes=72,
                  route="staged")
    cuda = torch.device("cuda")
    f2, i2 = sm.packed_factors(RES, MODES, "ortho", cuda)
    x = randn(train, gen, dtype=bf)
    g = randn(train, gen, dtype=bf)
    wg_ms = time_ms(lambda: sm.spectral_weight_grad(x, g, f2, i2, 2, bf))
    log("K2adj", case="weight_grad_bf16", ms=f"{wg_ms:.4f}")

    # f32 at the train shape: the adjoint kernel and the weight gradient
    # against autograd of the plain pass (an independent derivation)
    m = MODES
    x = randn((BATCH, RES, RES, WIDTH), gen)
    g = randn((BATCH, RES, RES, WIDTH), gen)
    wab = sm.mix_blocks(randn((WIDTH, WIDTH, MODES, 2), gen, 0.1), m)
    xr = x.reshape(-1, RES, WIDTH).requires_grad_()
    wr = sm.pack_blocks(wab).requires_grad_()
    sm.spectral_pass_reference(xr, f2, i2, wr, torch.float32).backward(
        g.reshape(-1, RES, WIDTH))
    dx = sm.spectral_axis_adjoint(g, wab, 2, "ortho", torch.float32)
    dw = sm.spectral_weight_grad(x, g, f2, i2, 2, torch.float32)
    ex = rel_l2(dx.reshape(xr.shape), xr.grad)
    ew = rel_l2(dw, wr.grad)
    log("K2adj", case="f32_vs_autograd", dx_rel_l2=f"{ex:.3e}",
        dwpk_rel_l2=f"{ew:.3e}", tol=1e-4)
    require(ex <= 1e-4 and ew <= 1e-4, f"f32 adjoint vs autograd: {ex} {ew}")

    # both axes at 48 x 64 (m = 25 / 33) through the conv's autograd
    # Function: dx (the H adjoint added into the W adjoint) and both
    # weights' gradients against the same inputs on the CPU
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        x = randn((BATCH, 48, 64, WIDTH), gen, dtype=dtype)
        g = randn((BATCH, 48, 64, WIDTH), gen, dtype=dtype)
        wy = randn((WIDTH, WIDTH, MODES, 2), gen, 0.1)
        wx = randn((WIDTH, WIDTH, MODES, 2), gen, 0.1)
        grads = []
        for dev in ("cuda", "cpu"):
            leaves = [t.detach().to(dev).requires_grad_()
                      for t in (x, wy, wx)]
            sm.factorized_spectral_conv_2d_pallas2(
                *leaves, MODES, compute_dtype=dtype).backward(g.to(dev))
            grads.append([t.grad.cpu() for t in leaves])
        errs = [rel_l2(a, b) for a, b in zip(*grads)]
        log("K2adj", case=f"both_axes_{str(dtype)[6:]}", shape="8x48x64x64",
            m="25/33", dx_rel_l2=f"{errs[0]:.3e}",
            dwy_rel_l2=f"{errs[1]:.3e}", dwx_rel_l2=f"{errs[2]:.3e}", tol=tol)
        require(max(errs) <= tol, f"conv gradients {dtype}: {errs}")
    return _with_h(w16, h16), _with_h(k3, k3h), _with_h(wide, wide_h)


def build_model(device, compute_dtype, spectral_impl, gen=None,
                ff_impl="fused", width=WIDTH):
    from resolution_pde_tpu_torch.models import FFNO2D

    return FFNO2D(in_channels=1, out_channels=1, width=width,
                  n_layers=LAYERS, n_modes=MODES, factor=FACTOR,
                  ff_weight_norm=True, n_ff_layers=FF_LAYERS,
                  layer_norm=True, dropout=0.0, compute_dtype=compute_dtype,
                  spectral_impl=spectral_impl, approx_gelu=True,
                  ff_impl=ff_impl, device=device, generator=gen)


# the kernels of the serving graphs, by a part of their symbol names on the
# card: K1f's forward kernels, the staged route's first stage (one a bf16
# pass), K3 (one launch a f32 pass at these shapes), K4 and K5
SYMBOLS = {"K1f": "fused_ff_fwd", "K2": "staged_forward_kernel",
           "K3": "spectral_pass_kernel", "K4": "vandermonde_kernel",
           "K5": "cauchy_kernel"}


def profiled(fn):
    """``fn()`` under torch.profiler (CPU and CUDA activities), the device
    synchronized before the profile closes; returns (result, profile)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof


def _device_kernels(prof) -> list:
    """The names of the kernels the profile recorded on the device (not
    its copies and fills)."""
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


# graph_executions' profile: idle host time on each side of the work, and
# the spin kernels (torch.cuda._sleep, which no graph runs) launched
# before it to take the profile's first device records
PROFILE_MARGIN_S, PROFILE_PRIMER = 0.05, 256


def graph_executions(fn, per_call: dict, calls: int, what: str) -> tuple:
    """Serve ``calls`` requests (``fn()``) through an engine's CUDA graphs
    under torch.profiler and count each kernel's executions inside the
    replays by its symbol name (``SYMBOLS``): each must be ``per_call[k]``
    a request. The kernels' Python counters count host launches, which a
    replay makes none of. Late in a long process the profiler can lose
    the first device records of a profile, whatever kernels they are
    (kineto counts them out of range); so the profile opens with
    PROFILE_MARGIN_S of idle time and PROFILE_PRIMER spin kernels,
    synchronized, before the work, and closes with the margin again. The
    log gives how many of the spin kernels' records arrived. Returns
    (result, {kernel: executions})."""
    def primed():
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(PROFILE_PRIMER):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        return out

    out, prof = profiled(primed)
    names = _device_kernels(prof)
    spins = sum("spin_kernel" in n for n in names)
    got = {k: sum(SYMBOLS[k] in n for n in names) for k in per_call}
    want = {k: v * calls for k, v in per_call.items()}
    log("graphs", what=what, executions=got, kernels=len(names) - spins,
        spin_records=f"{spins}/{PROFILE_PRIMER}")
    require(got == want, f"{what}: kernels executed in the graph replays "
            f"{got}, expected {want}")
    return out, got


def eager(eng, fn):
    """``fn()`` with the engine's graphs switched off (its private switch):
    the same engine run eagerly, for comparison."""
    eng._use_graphs = False
    try:
        return fn()
    finally:
        eng._use_graphs = True


def median_ms(fn, reps: int = 10) -> float:
    """Median host time of ``fn()`` (a request, which ends in its copy to
    the host) after 2 warm calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def warm_graphs(eng, buckets, counters, per_call, what, **kw) -> None:
    """Capture each (spatial, batch) bucket of ``buckets`` (with ``kw``,
    e.g. rollout_steps) on ``eng``, logging its capture seconds, and the
    peak memory with them all captured; each capture must launch the
    kernels ``per_call`` says twice from the host (its eager warm-up run
    and the run it captures; a forecast of s steps s times more)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds = {}
    for spatial, batch in buckets:
        before = counters()
        t0 = time.perf_counter()
        eng.compile_bucket(spatial, batch, **kw)
        seconds[f"{batch}x{spatial}"] = f"{time.perf_counter() - t0:.3f}"
        d = {k: counters()[k] - before[k] for k in per_call}
        steps = 1 + sum(kw.get("rollout_steps", ()))
        want = {k: 2 * v * steps for k, v in per_call.items()}
        require(d == want, f"{what}: capturing {spatial} x {batch} launched "
                f"{d}, expected {want}")
    log("graphs", what=what, capture_s=seconds, buckets=len(eng.buckets()),
        max_memory_allocated_mb=
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f}")


def run_slice(gen) -> dict:
    """FFNO2D serving through one CUDA graph per bucket: bf16 (K1f, the
    staged K2) and f32-exact (K1f f32, K3) engines, each bucket captured
    (capture seconds, peak memory), requests counted by their kernels'
    executions in the replays, graph against eager on the same engine,
    both against the CPU, and the median predict latency per bucket, graph
    and eager. Returns the executions of K1f and the spectral pass, bf16
    and f32."""
    from resolution_pde_tpu_torch.deploy import ServingEngine
    from resolution_pde_tpu_torch.ops.kernels import fused_ff, spectral_mix
    from resolution_pde_tpu_torch.ops.normalizers import SimpleNormalizer

    norms = dict(x_normalizer=SimpleNormalizer(0.1, 1.3),
                 y_normalizer=SimpleNormalizer(-0.2, 0.9))
    model = build_model("cuda", torch.bfloat16, "pallas2",
                        torch.Generator().manual_seed(SEED))
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    eng = ServingEngine(model, device="cuda", **norms)

    def counters():
        return {"K1f": fused_ff.launches, "K2": spectral_mix.wide_launches,
                "K3": spectral_mix.k3_launches}

    bf16_call = {"K1f": LAYERS, "K2": 2 * LAYERS}
    f32_call = {"K1f": LAYERS, "K3": 2 * LAYERS}
    t0 = time.perf_counter()
    warm_graphs(eng, [((r, r), BATCH) for r in (64, 128, RES)], counters,
                bf16_call, "ffno_bf16", rollout_steps=[4])
    log("slice", warmup_s=f"{time.perf_counter() - t0:.3f}",
        buckets=len(eng.buckets()))
    f32_model = build_model("cuda", None, "pallas")
    f32_model.load_state_dict(state)
    eng32 = ServingEngine(f32_model, device="cuda", **norms)
    warm_graphs(eng32, [((r, r), BATCH) for r in (64, 128, RES)]
                + [((128, 128), 2)], counters, f32_call, "ffno_f32")

    rng = np.random.default_rng(SEED)
    reqs = {res: rng.standard_normal((5 if res == RES else BATCH, 1, res,
                                      res)).astype(np.float32)
            for res in (RES, 64, 128)}
    x128 = rng.standard_normal((2, 1, 128, 128)).astype(np.float32)

    # the main path: every count from here comes from serving requests
    fused_ff.launches = spectral_mix.launches = 0
    spectral_mix.wide_launches = spectral_mix.k3_launches = 0
    launched = {"bf16": [0, 0], "f32": [0, 0]}
    outs = {}

    def serve(key, fn, per_call, calls, what):
        out, ex = graph_executions(fn, per_call, calls, what)
        spec = "K2" if key == "bf16" else "K3"
        launched[key] = [launched[key][0] + ex["K1f"],
                         launched[key][1] + ex[spec]]
        return out

    for res, x in reqs.items():
        outs[res] = serve("bf16", lambda x=x: eng.predict(x), bf16_call, 1,
                          f"bf16 predict at {res}^2")
    roll = serve("bf16", lambda: eng.forecast(reqs[RES], 4), bf16_call, 4,
                 "bf16 forecast of 4 steps")
    out32 = serve("f32", lambda: eng32.predict(x128), f32_call, 1,
                  "f32 predict of 2 at 128^2")
    x32 = rng.standard_normal((BATCH, 1, RES, RES)).astype(np.float32)
    y32 = serve("f32", lambda: eng32.predict(x32), f32_call, 1,
                f"f32 predict at {RES}^2")
    require(counters() == {"K1f": 0, "K2": 0, "K3": 0},
            f"serving through graphs launched kernels from the host: "
            f"{counters()}")
    log("slice", executions_bf16=launched["bf16"],
        executions_f32=launched["f32"])
    require(y32.shape == x32.shape and np.isfinite(y32).all(),
            f"f32 predict at {RES}^2: shape {y32.shape} or non-finite")
    for res, x in reqs.items():
        require(outs[res].shape == x.shape and np.isfinite(outs[res]).all(),
                f"predict at {res}^2: shape {outs[res].shape} or non-finite")
    require(roll.shape == (5, 4, 1, RES, RES) and np.isfinite(roll).all(),
            f"forecast: shape {roll.shape} or non-finite")

    # graph against eager on the same engines
    for name, e, x, got in (("bf16", eng, reqs[RES], outs[RES]),
                            ("f32", eng32, x32, y32)):
        ref = eager(e, lambda e=e, x=x: e.predict(x))
        log("graphs", what=f"ffno_{name} predict at {RES}^2",
            graph_vs_eager_max_abs=f"{np.abs(got - ref).max():.3e}",
            bit_equal=bool(np.array_equal(got, ref)))
        require(rel_l2(torch.from_numpy(got), torch.from_numpy(ref))
                <= 1e-6, f"{name}: graph replay vs eager")
    ref = eager(eng, lambda: eng.forecast(reqs[RES], 4))
    require(rel_l2(torch.from_numpy(roll), torch.from_numpy(ref)) <= 1e-6,
            "bf16 forecast: graph replay vs eager")

    # the same weights on the CPU through the plain versions, in f32
    cpu_model = build_model("cpu", None, "pallas2")
    cpu_model.load_state_dict(state)
    cpu_eng = ServingEngine(cpu_model, device="cpu", **norms)
    cpu_eng.warmup(spatial_shapes=[(128, 128)], batch_sizes=[2])
    ref = cpu_eng.predict(x128)
    err16 = rel_l2(torch.from_numpy(eng.predict(x128)), torch.from_numpy(ref))
    err32 = rel_l2(torch.from_numpy(out32), torch.from_numpy(ref))
    log("slice", bf16_vs_cpu_f32_rel_l2=f"{err16:.3e}", tol=3e-2,
        f32_vs_cpu_f32_rel_l2=f"{err32:.3e}", tol32=1e-4)
    require(err16 <= 3e-2, f"bf16 slice vs CPU f32: {err16}")
    require(err32 <= 1e-4, f"f32 slice vs CPU f32: {err32}")

    # median predict latency per bucket, graph and eager, in turns
    for name, e in (("bf16", eng), ("f32_exact", eng32)):
        for res in (64, 128, RES):
            x = rng.standard_normal((BATCH, 1, res, res)).astype(np.float32)
            g1 = median_ms(lambda: e.predict(x))
            e1 = eager(e, lambda: median_ms(lambda: e.predict(x)))
            g2 = median_ms(lambda: e.predict(x))
            log("latency", model=f"ffno_{name}", bucket=f"{BATCH}x{res}^2",
                graph_median_ms=f"{g1:.3f}/{g2:.3f}",
                eager_median_ms=f"{e1:.3f}")
    return launched


def _counts():
    from resolution_pde_tpu_torch.ops.kernels import fused_ff, spectral_mix

    return (fused_ff.launches, fused_ff.bwd_launches, spectral_mix.launches,
            spectral_mix.adjoint_launches)


def _flat_grads(model) -> torch.Tensor:
    return torch.cat([p.grad.detach().float().reshape(-1).cpu()
                      for p in model.parameters()])


def run_train() -> dict:
    """The train slice. Every kernel launch counted here comes from a
    Trainer step; returns the launches by kernel and precision."""
    from resolution_pde_tpu_torch.ops.kernels import fused_ff, spectral_mix
    from resolution_pde_tpu_torch.ops.losses import relative_l2
    from resolution_pde_tpu_torch.train import (Trainer, restore_checkpoint,
                                                save_checkpoint)

    per_step = [LAYERS, LAYERS, 2 * LAYERS, 2 * LAYERS]  # K1, K1b, K2, adj
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((BATCH, 1, RES, RES)).astype(np.float32)
    y = np.roll(x, 7, axis=-1)
    xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    init = build_model("cpu", torch.bfloat16, "pallas2",
                       torch.Generator().manual_seed(SEED + 1)).state_dict()

    def trainer_for(compute_dtype, spectral_impl, ff_impl="fused"):
        model = build_model("cuda", compute_dtype, spectral_impl,
                            ff_impl=ff_impl)
        model.load_state_dict(init)
        trainer = Trainer(model, learning_rate=1e-3, device="cuda")
        return trainer, trainer.init()

    def step(trainer, state, xb, yb, what):
        before = _counts()
        state, loss = trainer.train_step(state, xb, yb)
        d = [a - b for a, b in zip(_counts(), before)]
        require(d == per_step, f"{what}: a step launched (K1, K1b, K2, "
                f"adjoint) {d}, expected {per_step}")
        return state, loss

    # the main path: every launch counted from here comes from train steps
    fused_ff.launches = fused_ff.bwd_launches = 0
    spectral_mix.launches = spectral_mix.adjoint_launches = 0
    spectral_mix.wide_launches = 0
    launched = {"bf16": [0, 0, 0, 0], "f32": [0, 0, 0, 0]}

    def tally(key, before):
        launched[key] = [t + a - b for t, a, b in
                         zip(launched[key], _counts(), before)]

    before = _counts()
    trainer, state = trainer_for(torch.bfloat16, "pallas2")
    for _ in range(3):
        state, loss = step(trainer, state, xd, yd, "warm step")
    warm = float(loss)
    require(np.isfinite(warm), f"non-finite warm loss {warm}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(20):
        t = time.perf_counter()
        state, loss = step(trainer, state, xd, yd, "timed step")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(times)
    log("train", cell=f"{BATCH}x{RES}^2 bf16", warm_loss=f"{warm:.6f}",
        first_loss=f"{losses[0]:.6f}", last_loss=f"{losses[-1]:.6f}",
        median_step_ms=f"{step_ms:.3f}",
        samples_per_s=f"{BATCH / step_ms * 1e3:.2f}",
        max_memory_allocated_mb=f"{peak / 2**20:.1f}")
    require(all(np.isfinite(losses)), f"non-finite losses {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name, p in state.model.named_parameters():
        gr = p.grad
        require(gr is not None and bool(torch.isfinite(gr).all())
                and float(gr.abs().sum()) > 0,
                f"parameter {name}: gradient missing, non-finite or zero")

    # resume: save at this step, run 2, restore, run the same 2 again
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, state)
        first = []
        for _ in range(2):
            state, loss = step(trainer, state, xd, yd, "resume step")
            first.append(float(loss))
        state, _ = restore_checkpoint(tmp, state)
        again = []
        for _ in range(2):
            state, loss = step(trainer, state, xd, yd, "resumed step")
            again.append(float(loss))
    log("train", resume_losses=first, repeated=again)
    require(first == again, f"resume not exact: {first} vs {again}")

    # 3 steps with the pre-activations saved instead of recomputed
    trainer, state = trainer_for(torch.bfloat16, "pallas2", "fused_saved")
    saved, saved_ms = [], []
    for _ in range(3):
        t = time.perf_counter()
        state, loss = step(trainer, state, xd, yd, "fused_saved step")
        saved.append(float(loss))  # syncs
        saved_ms.append((time.perf_counter() - t) * 1e3)
    log("train", fused_saved_losses=[f"{v:.6f}" for v in saved],
        fused_saved_step_ms=[f"{v:.3f}" for v in saved_ms])
    require(all(np.isfinite(saved)), f"fused_saved losses {saved}")

    # one step's gradients at 128², batch 2, from the initial weights
    x128 = rng.standard_normal((2, 1, 128, 128)).astype(np.float32)
    y128 = np.roll(x128, 7, axis=-1)
    cpu = build_model("cpu", None, "pallas2")
    cpu.load_state_dict(init)
    relative_l2(cpu(torch.from_numpy(x128)),
                torch.from_numpy(y128)).backward()
    ref = _flat_grads(cpu)
    trainer, state = trainer_for(torch.bfloat16, "pallas2")
    state, _ = step(trainer, state, x128, y128, "bf16 gradient step")
    err16 = rel_l2(_flat_grads(state.model), ref)
    tally("bf16", before)
    staged = launched["bf16"][2] + launched["bf16"][3]
    require(spectral_mix.wide_launches == staged,
            f"bf16 steps: {spectral_mix.wide_launches} of {staged} spectral "
            "launches on the staged route")
    before = _counts()
    trainer, state = trainer_for(None, "pallas")
    state, _ = step(trainer, state, x128, y128, "f32 gradient step")
    err32 = rel_l2(_flat_grads(state.model), ref)
    # the f32-exact step at the train shape: 2 warm steps, 3 timed
    trainer, state = trainer_for(None, "pallas")
    f32_ms, f32_losses = [], []
    for i in range(5):
        t = time.perf_counter()
        state, loss = step(trainer, state, xd, yd, "f32 step")
        torch.cuda.synchronize()
        f32_losses.append(float(loss))
        if i >= 2:
            f32_ms.append((time.perf_counter() - t) * 1e3)
    log("train", cell=f"{BATCH}x{RES}^2 f32_exact",
        median_step_ms=f"{statistics.median(f32_ms):.3f}",
        step_ms=[f"{v:.3f}" for v in f32_ms],
        losses=[f"{v:.6f}" for v in f32_losses])
    require(all(np.isfinite(f32_losses)), f"f32 step losses {f32_losses}")
    tally("f32", before)
    require(spectral_mix.wide_launches == staged,
            "f32 steps launched the staged route")
    log("train", grads_bf16_vs_cpu_f32_rel_l2=f"{err16:.3e}", tol=3e-2,
        grads_f32_vs_cpu_f32_rel_l2=f"{err32:.3e}", tol32=1e-4)
    require(err16 <= 3e-2, f"bf16 gradients vs CPU f32: {err16}")
    require(err32 <= 1e-4, f"f32 gradients vs CPU f32: {err32}")
    log("train", launches_k1=_counts()[0], launches_k1b=_counts()[1],
        launches_k2=_counts()[2], launches_adjoint=_counts()[3])
    return dict(launched=launched, step_ms=step_ms)


def run_wide() -> dict:
    """FFNO2D at width WIDE on spectral_impl 'pallas2' in bf16, whose
    spectral passes and adjoints run on the staged route (as every bf16
    pass does, spectral_mix.spectral_route): a predict of 5 through
    ServingEngine at 8 x 256² and 3 Trainer steps at 8 x 256² from the
    same random weights (finite losses, every gradient finite and
    non-zero), each launching the staged route twice a layer (and twice for
    the adjoints); then the predict and one step's gradients at 2 x 128²
    against the same weights in f32 on the CPU (relative L2 3e-2, as the
    width-64 slice). Returns the launches of the predict and the 3 steps,
    read just after them: the staged route's ("wide"; of them passes "k2"
    and adjoints "adj") and K1f's and K1b's in bf16 ("fwd", "bwd")."""
    from resolution_pde_tpu_torch.deploy import ServingEngine
    from resolution_pde_tpu_torch.ops.kernels import fused_ff, spectral_mix
    from resolution_pde_tpu_torch.ops.losses import relative_l2
    from resolution_pde_tpu_torch.train import Trainer

    init = build_model("cpu", torch.bfloat16, "pallas2",
                       torch.Generator().manual_seed(SEED + 2),
                       width=WIDE).state_dict()

    def model(device="cuda", compute_dtype=torch.bfloat16):
        m = build_model(device, compute_dtype, "pallas2", width=WIDE)
        m.load_state_dict(init)
        return m

    eng = ServingEngine(model(), device="cuda")
    eng.warmup(spatial_shapes=[(128, 128), (RES, RES)],
               batch_sizes=[2, BATCH])
    rng = np.random.default_rng(SEED + 2)
    x = rng.standard_normal((5, 1, RES, RES)).astype(np.float32)
    xt = rng.standard_normal((BATCH, 1, RES, RES)).astype(np.float32)
    xd = torch.from_numpy(xt).cuda()
    yd = torch.roll(xd, 7, dims=-1)
    x128 = rng.standard_normal((2, 1, 128, 128)).astype(np.float32)
    y128 = np.roll(x128, 7, axis=-1)

    # the main path of the staged route: every launch counted from here
    # comes from the predicts and steps below
    fused_ff.launches = fused_ff.bwd_launches = 0
    spectral_mix.launches = spectral_mix.adjoint_launches = 0
    spectral_mix.wide_launches = 0

    def wide_since(before, what, want):
        d = spectral_mix.wide_launches - before
        require(d == want, f"width {WIDE} {what}: {d} launches on the wide "
                f"route, expected {want}")

    # the predict replays its bucket's graph: its kernels are counted by
    # their executions in the replay
    y, served = graph_executions(lambda: eng.predict(x),
                                    {"K1f": LAYERS, "K2": 2 * LAYERS}, 1,
                                    f"width {WIDE} predict")
    require(y.shape == x.shape and np.isfinite(y).all(),
            f"width {WIDE} predict: shape {y.shape} or non-finite")
    trainer = Trainer(model(), learning_rate=1e-3, device="cuda")
    state = trainer.init()
    losses, step_ms = [], []
    for _ in range(3):
        before = spectral_mix.wide_launches
        t = time.perf_counter()
        state, loss = trainer.train_step(state, xd, yd)
        losses.append(float(loss))  # syncs
        step_ms.append((time.perf_counter() - t) * 1e3)
        wide_since(before, "train step", 4 * LAYERS)
    launched = dict(wide=spectral_mix.wide_launches + served["K2"],
                    k2=spectral_mix.launches + served["K2"],
                    adj=spectral_mix.adjoint_launches,
                    fwd=fused_ff.launches + served["K1f"],
                    bwd=fused_ff.bwd_launches)
    require(launched["k2"] + launched["adj"] == launched["wide"],
            f"width {WIDE}: spectral launches {launched} off the staged "
            "route")
    require(launched["fwd"] == 4 * LAYERS and launched["bwd"] == 3 * LAYERS,
            f"width {WIDE}: FeedForward launches {launched}, expected "
            f"{4 * LAYERS} forward and {3 * LAYERS} backward")
    require(all(np.isfinite(losses)), f"width {WIDE} losses {losses}")
    for name, prm in state.model.named_parameters():
        gr = prm.grad
        require(gr is not None and bool(torch.isfinite(gr).all())
                and float(gr.abs().sum()) > 0,
                f"width {WIDE} parameter {name}: gradient missing, "
                "non-finite or zero")
    log("wide", model=f"FFNO2D width {WIDE} pallas2 bf16", losses=[f"{v:.6f}" for v in losses],
        step_ms=[f"{v:.3f}" for v in step_ms], launches=launched)

    # against the same weights in f32 on the CPU through the plain versions
    cpu = model("cpu", None)
    cpu_eng = ServingEngine(cpu, device="cpu")
    cpu_eng.warmup(spatial_shapes=[(128, 128)], batch_sizes=[2])
    before = spectral_mix.wide_launches
    err = rel_l2(torch.from_numpy(eng.predict(x128)),
                 torch.from_numpy(cpu_eng.predict(x128)))
    relative_l2(cpu(torch.from_numpy(x128)),
                torch.from_numpy(y128)).backward()
    trainer = Trainer(model(), learning_rate=1e-3, device="cuda")
    state, _ = trainer.train_step(trainer.init(), x128, y128)
    gerr = rel_l2(_flat_grads(state.model), _flat_grads(cpu))
    # the predict replays a graph, so only the step launches from the host
    wide_since(before, "predict and step at 128^2", 4 * LAYERS)
    log("wide", predict_vs_cpu_f32_rel_l2=f"{err:.3e}",
        grads_vs_cpu_f32_rel_l2=f"{gerr:.3e}", tol=3e-2)
    require(err <= 3e-2, f"width {WIDE} predict vs CPU f32: {err}")
    require(gerr <= 3e-2, f"width {WIDE} gradients vs CPU f32: {gerr}")
    return launched


def _log_uniform_dt(h, gen):
    """log-uniform timesteps in [1e-3, 1e-1], as the S4 layers draw them."""
    u = torch.rand(h, generator=gen)
    return u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3)


def _within(got, ref, rtol, atol) -> float:
    """The largest |got - ref| over atol + rtol |ref| (at most 1 passes)."""
    return float(((got - ref).abs() / (atol + rtol * ref.abs())).max())


def _close(got, ref, rtol, atol) -> bool:
    return _within(got, ref, rtol, atol) <= 1.0


def check_s4_kernels(gen) -> tuple:
    """K4 and K5 against their plain versions on the card, through both of
    each kernel's entries: the fused one the model runs (the JAX wrapper's
    inputs, the operands formed in the launch) and the plane one (f32
    planes in, and for K5 the four sums out), on the operands the S4
    layers give them: the slice's shapes (2 kernel channels x 64 features
    = 128 rows; K4 N/2 = 32, K5 N = 64; L = 512), S4ND's (one channel x
    64 features at L = 64, 128 and 256) and a ragged 18 rows x N 8 x L 40
    (and K5 at 3 channels, 27 rows, whose rows no pair of channels
    shares); and K4 at a slow decay (Re A = -1e-4, dt = 0.1, L = 512),
    where each entry must be no farther from a float64 evaluation than its
    plain version. Times are device times in CUDA graphs (eager calls of a
    few microseconds leave the device idle between them)."""
    from resolution_pde_tpu_torch.ops import ssm
    from resolution_pde_tpu_torch.ops.kernels import cauchy, vandermonde

    def k4(ch, h, n_half, L, label, re_a=-0.5, dt=None):
        # S4D-Lin A = -1/2 + i pi n (the s4d_1d layers' init), random C
        A = torch.complex(torch.full((h, n_half), re_a),
                          np.pi * torch.arange(n_half).float().expand(h, -1))
        C = torch.complex(torch.randn((ch, h, n_half), generator=gen),
                          torch.randn((ch, h, n_half), generator=gen))
        log_dt = (_log_uniform_dt(h, gen) if dt is None
                  else torch.full((h,), math.log(dt)))
        C, A, log_dt = C.cuda(), A.cuda(), log_dt.cuda()
        planes = [t.contiguous()
                  for t in vandermonde.s4d_operands(C, A, log_dt)]
        got = {"plane": vandermonde.vandermonde(*planes, L),
               "fused": vandermonde.s4d_kernel_pallas(C, A, log_dt, L)}
        ref = {"plane": vandermonde.vandermonde_reference(*planes, L),
               "fused": vandermonde.s4d_kernel_reference(C, A, log_dt, L)}
        torch.cuda.synchronize()
        rec = {}
        for e in got:
            err, mx = rel_l2(got[e], ref[e]), max_abs(got[e], ref[e])
            ok = _close(got[e], ref[e], 1e-3, 1e-4)
            rec[e] = dict(max_abs_err=mx, rel_l2=err)
            log("K4", case=f"{label}_{e}", rows=ch * h, n=n_half, L=L,
                rel_l2=f"{err:.3e}", max_abs=f"{mx:.3e}",
                tol="1e-5 and rtol 1e-3/atol 1e-4" if dt is None
                else "no farther from float64 than plain")
            require(bool(torch.isfinite(got[e]).all()),
                    f"K4 {label} {e}: non-finite")
            if dt is None:
                require(err <= 1e-5 and ok,
                        f"K4 {label} {e}: rel_l2 {err}, elementwise {ok}")
        if dt is not None:
            # float64 evaluations: of the same f32 planes (the plane
            # entry's function) and of the same C, A, log_dt (the fused
            # entry's)
            exact = {"plane": vandermonde.vandermonde_reference(
                        *(p.double() for p in planes), L),
                     "fused": vandermonde.s4d_kernel_reference(
                        C.to(torch.complex128), A.to(torch.complex128),
                        log_dt.double(), L)}
            for e in got:
                kern, plain = (rel_l2(x[e], exact[e]) for x in (got, ref))
                log("K4", case=f"{label}_{e}_vs_float64",
                    kernel_rel_l2=f"{kern:.4e}", plain_rel_l2=f"{plain:.4e}")
                require(kern <= plain, f"K4 {label} {e}: {kern} from float64, "
                        f"farther than the plain version's {plain}")
            return None
        fused_ms = graph_ms(lambda: vandermonde.s4d_kernel_pallas(
            C, A, log_dt, L))
        plain = graph_ms(lambda: vandermonde.s4d_kernel_reference(
            C, A, log_dt, L))
        plane_ms = graph_ms(lambda: vandermonde.vandermonde(*planes, L))
        plane_plain = graph_ms(lambda: vandermonde.vandermonde_reference(
            *planes, L))
        eager = time_ms(lambda: vandermonde.s4d_kernel_pallas(C, A, log_dt,
                                                              L))
        rows = ch * h
        log("K4", case=label, ms=f"{fused_ms:.5f}", plain_ms=f"{plain:.5f}",
            plane_ms=f"{plane_ms:.5f}", plane_plain_ms=f"{plane_plain:.5f}",
            eager_call_ms=f"{eager:.5f}")
        # bytes: C, A and log_dt in, K out
        return dict(max_abs_err=rec["fused"]["max_abs_err"], ms=fused_ms,
                    plain_ms=plain, plane_ms=plane_ms,
                    plane_plain_ms=plane_plain,
                    **bound(vandermonde.operations(rows, h, n_half, L),
                            8.0 * (rows + h) * n_half + 4.0 * h
                            + 4.0 * rows * L, PEAK_F32))

    def k5(ch, h, n, L, label):
        # the s4_1d layers' HiPPO-LegS Lambda, P, B and a random C-tilde
        lam, p, b, _ = ssm.make_dplr_hippo(n)
        lam, p, b = (torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
            z, (h, n)), np.complex64)) for z in (lam, p, b))
        C = torch.complex(torch.randn((ch * h, n), generator=gen),
                          torch.randn((ch * h, n), generator=gen)) * 0.5 ** 0.5
        log_dt = _log_uniform_dt(h, gen)
        lam, p, b, C, log_dt = (t.cuda() for t in (lam, p, b, C, log_dt))
        v, g, _ = cauchy.dplr_operands(lam, p, b, C, log_dt, L)
        lam_rows = lam.repeat(ch, 1)
        planes = [t.contiguous() for t in (v.real, v.imag, lam_rows.real,
                                           lam_rows.imag, g.real, g.imag)]
        args = (lam, p, b, C, log_dt, L)
        got = {"sums": torch.stack(cauchy.cauchy_sums(*planes)),
               "fused": torch.view_as_real(cauchy.dplr_at_roots(*args))}
        ref = {"sums": torch.stack(cauchy.cauchy_reference(*planes)),
               "fused": torch.view_as_real(
                   cauchy.dplr_at_roots_reference(*args))}
        # the fused entry's elementwise hold: rtol 2e-4 / atol 2e-5 on the
        # values at the roots, and beyond it at most AT_ROOTS_LIMIT times
        # 2^-24 the rounding's scale, which near the Woodbury combination's
        # cancellations is far above |at_roots|; the limit is taken between
        # two readings made here: the plain version with the states in
        # reverse order (rounding alone) must lie within it, and with one
        # state's C~ off by 2^-10 (a fault) beyond it
        scale = cauchy.dplr_at_roots_scale(*args)
        at_plain = torch.view_as_complex(ref["fused"])
        sound = cauchy.at_roots_departure(
            cauchy.dplr_at_roots_reference(
                *(t.flip(-1) for t in args[:4]), log_dt, L), at_plain, scale)
        faulty = C.clone()
        faulty[:, n // 2] *= 1 + 2.0 ** -10
        fault = cauchy.at_roots_departure(
            cauchy.dplr_at_roots_reference(lam, p, b, faulty, log_dt, L),
            at_plain, scale)
        limit = cauchy.AT_ROOTS_LIMIT
        inv_fft = lambda z: torch.fft.ifft(  # noqa: E731
            torch.view_as_complex(z), n=L, dim=-1).real
        torch.cuda.synchronize()
        rec = {}
        for e in got:
            err, mx = rel_l2(got[e], ref[e]), max_abs(got[e], ref[e])
            # elementwise, on the real and the imaginary parts
            ok = _close(got[e], ref[e], 2e-4, 2e-5)
            extra = {}
            if e == "fused":
                outside = int((~((got[e] - ref[e]).abs()
                                 <= 2e-5 + 2e-4 * ref[e].abs())).sum())
                kernel = cauchy.at_roots_departure(
                    torch.view_as_complex(got[e]), at_plain, scale)
                kg, kr = inv_fft(got[e]), inv_fft(ref[e])
                ok = kernel <= limit and _close(kg, kr, 2e-4, 2e-5)
                extra = dict(outside_rtol_atol=outside,
                             departure=f"{kernel:.4g}",
                             departure_reversed_states=f"{sound:.4g}",
                             departure_fault=f"{fault:.4g}", limit=limit,
                             K_rel_l2=f"{rel_l2(kg, kr):.3e}",
                             K_max_abs=f"{max_abs(kg, kr):.3e}")
            rec[e] = mx
            log("K5", case=f"{label}_{e}", rows=ch * h, n=n, L=L,
                rel_l2=f"{err:.3e}", max_abs=f"{mx:.3e}",
                tol="1e-5 and rtol 2e-4/atol 2e-5"
                + (" (at the roots, beyond it the departure limit; and on K)"
                   if e == "fused" else ""), **extra)
            require(bool(torch.isfinite(got[e]).all()) and err <= 1e-5 and ok,
                    f"K5 {label} {e}: rel_l2 {err}, elementwise {ok}")
        require(sound <= limit < fault,
                f"K5 {label}: the departure limit {limit} does not lie "
                f"between rounding ({sound}) and a fault ({fault})")
        fused_ms = graph_ms(lambda: cauchy.dplr_at_roots(*args))
        plain = graph_ms(lambda: cauchy.dplr_at_roots_reference(*args))
        sums_ms = graph_ms(lambda: cauchy.cauchy_sums(*planes))
        sums_plain = graph_ms(lambda: cauchy.cauchy_reference(*planes))
        eager = time_ms(lambda: cauchy.dplr_at_roots(*args))
        rows = ch * h
        log("K5", case=label, ms=f"{fused_ms:.5f}", plain_ms=f"{plain:.5f}",
            sums_ms=f"{sums_ms:.5f}", sums_plain_ms=f"{sums_plain:.5f}",
            eager_call_ms=f"{eager:.5f}")
        # bytes: Lambda, P, B, C-tilde and log_dt in, the (rows, L) complex
        # values at the roots out
        return dict(max_abs_err=rec["fused"], ms=fused_ms, plain_ms=plain,
                    sums_ms=sums_ms, sums_plain_ms=sums_plain,
                    **bound(cauchy.operations(rows, h, n, L),
                            8.0 * (3 * h + rows) * n + 4.0 * h
                            + 8.0 * rows * L, PEAK_F32))

    k4_out = k4(2, S4["d_model"], S4_STATE // 2, 512, "s4d_1d")
    k4(2, 9, 8, 40, "ragged")
    k4(2, S4["d_model"], S4_STATE // 2, 512, "slow_decay", re_a=-1e-4,
       dt=0.1)
    k5_out = k5(2, S4["d_model"], S4_STATE, 512, "s4_1d")
    k5(2, 9, 8, 40, "ragged")
    # an odd number of channels: a block a row, no pair of channels
    k5(3, 9, 8, 40, "ragged_3ch")
    # S4ND's per-axis kernels (phase 17): one channel of s4_2d.yaml's 64
    # features at each axis length it serves
    for L in S4ND_SERVE:
        k4(1, S4ND_WIDTH, S4_STATE // 2, L, f"s4nd_{L}")
        k5(1, S4ND_WIDTH, S4_STATE, L, f"s4nd_{L}")
    return k4_out, k5_out


def build_s4(mode, kernel_impl, device, gen=None):
    from resolution_pde_tpu_torch.models import S4Model

    return S4Model(**S4, mode=mode, kernel_impl=kernel_impl, device=device,
                   generator=gen)


def run_s4_slice() -> dict:
    """S4Model in both modes on the kernels' route behind ServingEngine on
    the GPU, one CUDA graph per bucket: each bucket captured (capture
    seconds, peak memory), requests counted by their kernel's executions
    in the replays, graph against eager on the same engine, the median
    predict latency per bucket, graph and eager, and the device's idle
    share over 10 predicts at 16 x 512; one predict against the CPU and
    the jnp route. Returns the executions of K5 (dplr) and K4 (diag)."""
    from resolution_pde_tpu_torch.deploy import ServingEngine
    from resolution_pde_tpu_torch.ops.kernels import cauchy, vandermonde
    from resolution_pde_tpu_torch.ops.normalizers import SimpleNormalizer

    norms = dict(x_normalizer=SimpleNormalizer(0.1, 1.3),
                 y_normalizer=SimpleNormalizer(-0.2, 0.9))
    d_in, layers = S4["d_input"], S4["n_layers"]
    launched = {}

    def counters():
        return {"K4": vandermonde.launches, "K5": cauchy.launches}

    for mode, name, other in (("dplr", "K5", "K4"), ("diag", "K4", "K5")):
        per_call = {name: layers, other: 0}
        model = build_s4(mode, "pallas", "cuda",
                         torch.Generator().manual_seed(SEED))
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        eng = ServingEngine(model, device="cuda", **norms)
        t0 = time.perf_counter()
        warm_graphs(eng, [(n, S4_BATCH) for n in S4_LENGTHS], counters,
                    per_call, f"s4_{mode}", in_channels=d_in)
        log("s4", mode=mode, warmup_s=f"{time.perf_counter() - t0:.3f}",
            buckets=len(eng.buckets()))
        rng = np.random.default_rng(SEED)
        reqs = {n: rng.standard_normal((5 if n == 512 else S4_BATCH, d_in,
                                        n)).astype(np.float32)
                for n in S4_LENGTHS}
        x256 = rng.standard_normal((2, d_in, 256)).astype(np.float32)

        # the main path: every count from here comes from requests
        cauchy.launches = vandermonde.launches = 0
        executed = 0

        def predict(x, what, calls=1):
            nonlocal executed
            out, ex = graph_executions(lambda: eng.predict(x), per_call,
                                          calls, f"{mode} {what}")
            executed += ex[name]
            require(out.shape == (x.shape[0], 1, x.shape[2])
                    and np.isfinite(out).all(),
                    f"{mode} {what}: shape {out.shape} or non-finite")
            return out

        for n, x in reqs.items():
            predict(x, f"predict of {x.shape[0]} at L {n}")
        got = predict(x256, "predict of 2 at L 256")
        require(counters() == {"K4": 0, "K5": 0},
                f"{mode}: serving through graphs launched {counters()} "
                "from the host")
        launched[mode] = executed
        log("s4", mode=mode, **{f"executions_{name}": executed})

        # graph against eager on the same engine, bit for bit
        for n, x in reqs.items():
            g, e = eng.predict(x), eager(eng, lambda x=x: eng.predict(x))
            log("graphs", what=f"s4_{mode} predict at L {n}",
                graph_vs_eager_max_abs=f"{np.abs(g - e).max():.3e}",
                bit_equal=bool(np.array_equal(g, e)))
            require(rel_l2(torch.from_numpy(g), torch.from_numpy(e)) <= 1e-6,
                    f"{mode}: graph replay vs eager at L {n}")
        # median latency per bucket, graph and eager, in turns
        for n in S4_LENGTHS:
            x = rng.standard_normal((S4_BATCH, d_in, n)).astype(np.float32)
            g1 = median_ms(lambda: eng.predict(x))
            e1 = eager(eng, lambda: median_ms(lambda: eng.predict(x)))
            g2 = median_ms(lambda: eng.predict(x))
            log("latency", model=f"s4_{mode}", bucket=f"{S4_BATCH}x{n}",
                graph_median_ms=f"{g1:.3f}/{g2:.3f}",
                eager_median_ms=f"{e1:.3f}")
        # the device's idle share over 10 predicts of 16 x 512
        x = rng.standard_normal((S4_BATCH, d_in, 512)).astype(np.float32)
        for _ in range(3):
            eng.predict(x)
        def ten():
            t0 = time.perf_counter()
            for _ in range(10):
                eng.predict(x)
            return (time.perf_counter() - t0) * 1e3 / 10

        host_ms, prof = profiled(ten)
        if _device_kernels(prof):
            busy_ms, idle = _idle_share(prof)
            log("s4", mode=mode, profiled="10 predicts of 16 x 512 (graphs)",
                host_ms_per_predict=f"{host_ms:.3f}",
                device_busy_ms_per_predict=f"{busy_ms / 10:.4f}",
                device_idle_share=f"{idle:.4f}")
        else:
            log("s4", mode=mode, device_idle_share="not measured (the "
                "profiler recorded no kernel inside a replay)")

        # the same weights on the CPU through the plain versions, and on the
        # card through the jnp route; a predict of 2 pads to the bucket of 16
        cpu = build_s4(mode, "pallas", "cpu")
        cpu.load_state_dict(state)
        cpu_eng = ServingEngine(cpu, device="cpu", **norms)
        cpu_eng.warmup(spatial_shapes=[256], batch_sizes=[2],
                       in_channels=d_in)
        err_cpu = rel_l2(torch.from_numpy(got),
                         torch.from_numpy(cpu_eng.predict(x256)))
        jnp_model = build_s4(mode, "jnp", "cuda")
        jnp_model.load_state_dict(state)
        jnp_eng = ServingEngine(jnp_model, device="cuda", **norms)
        jnp_eng.warmup(spatial_shapes=[256], batch_sizes=[2],
                       in_channels=d_in)
        err_jnp = rel_l2(torch.from_numpy(got),
                         torch.from_numpy(jnp_eng.predict(x256)))
        log("s4", mode=mode, vs_cpu_plain_rel_l2=f"{err_cpu:.3e}",
            vs_jnp_route_rel_l2=f"{err_jnp:.3e}", tol=1e-4)
        require(err_cpu <= 1e-4, f"{mode} vs the CPU: {err_cpu}")
        require(err_jnp <= 1e-4, f"{mode} vs the jnp route: {err_jnp}")

        # the kernels are forward-only: a backward must raise, not return
        # detached gradients
        xb = torch.from_numpy(x256).cuda()
        try:
            model(xb).square().mean().backward()
            raised = False
        except NotImplementedError as e:
            raised = "forward-only" in str(e)
        require(raised, f"{mode}: backward() through the kernels' route "
                "did not raise")
    return launched


# the S4 family's training (configs/model/s4_1d.yaml and s4d_1d.yaml,
# dataset/ks_s4.yaml, training/default.yaml, depth cut to S4_EPOCHS epochs)
# on a synthetic stand-in for the KS files: KS_TRAJ trajectories x
# KS_FRAMES frames x KS_RES points, split as the train, valid and test files
KS_TRAJ, KS_FRAMES, KS_RES, KS_MODES = 32, 51, 512, 16
KS_SPLIT = (24, 4, 4)
S4_EPOCHS = 2
S4_RESOLUTIONS = [32, 64, 128, 256, 512]


def make_ks_splits() -> tuple:
    """A synthetic stand-in for the KS files, not KS physics: smooth random
    fields (Fourier modes k <= KS_MODES, from SEED) under a linear
    dispersive and diffusive evolution, per frame a phase 0.15 k + 4e-5 k^3
    and a decay 2e-4 k^2 of mode k, evolved exactly, so the next frame is
    one fixed linear map of the last. The (train, valid, test)
    trajectories (b, t, s), float32."""
    rng = np.random.default_rng(SEED)
    k = np.arange(KS_RES // 2 + 1)
    coef = (rng.standard_normal((KS_TRAJ, k.size))
            + 1j * rng.standard_normal((KS_TRAJ, k.size))) * (k <= KS_MODES)
    step = np.exp(-1j * (0.15 * k + 4e-5 * k ** 3) - 2e-4 * k ** 2)
    u = np.stack([np.fft.irfft(coef * step ** t, n=KS_RES)
                  for t in range(KS_FRAMES)], axis=1)
    u = (u / u[:, 0].std()).astype(np.float32)
    a, b = KS_SPLIT[0], KS_SPLIT[0] + KS_SPLIT[1]
    return u[:a], u[a:b], u[b:]


def run_s4_train() -> dict:
    """The S4 family from training to serving, at s4_1d.yaml's and
    s4d_1d.yaml's width as shipped (d_input 15, d_model 64, 4 layers,
    dropout 0.2, f32, the jnp route; batch 16, the cosine schedule and
    ssm_lr through cli.common.build_trainer): the window dataset through
    ks_window_splits (window 15), S4_EPOCHS epochs of Trainer.fit (the
    loss must fall and stay finite, the state-space group's rate the
    ratio times the main one at every step), a checkpoint saved with
    block=False after each epoch (the loop's stall timed beside a blocking
    save), the sweep at S4_RESOLUTIONS and the window rollout of 16 steps
    at each. Then the checkpoint served through
    ServingEngine.from_checkpoint in S4Model(kernel_impl='pallas'), graphs
    at 16 x S4_LENGTHS: replay against the same engine run eagerly, and
    against the jnp route of the trained model (1e-4), each request
    executing K5 (dplr) or K4 (diag) once a layer. Returns those
    executions."""
    from resolution_pde_tpu_torch.cli import common
    from resolution_pde_tpu_torch.configs import model_kwargs, parse_cli
    from resolution_pde_tpu_torch.data.factories import ks_window_splits
    from resolution_pde_tpu_torch.data.transforms import reduce_trajectories
    from resolution_pde_tpu_torch.deploy import ServingEngine
    from resolution_pde_tpu_torch.evaluation import (
        evaluate_all_resolutions, evaluate_rollout_all_resolutions)
    from resolution_pde_tpu_torch.ops.kernels import cauchy, vandermonde
    from resolution_pde_tpu_torch.train import (save_checkpoint,
                                                wait_for_checkpoints)

    t_phase = time.perf_counter()
    splits = make_ks_splits()
    log("s4_train", data=[tuple(u.shape) for u in splits],
        what="synthetic stand-in (dispersed, diffused random fields), not "
             "KS physics")
    launched = {}

    def counters():
        return {"K4": vandermonde.launches, "K5": cauchy.launches}

    with tempfile.TemporaryDirectory() as tmp:
        for cfg_name, mode, kname, other in (("s4_1d", "dplr", "K5", "K4"),
                                             ("s4d_1d", "diag", "K4", "K5")):
            cfg = parse_cli([f"model={cfg_name}", "dataset=ks_s4",
                             f"training.epochs={S4_EPOCHS}"])
            dp = cfg.dataset.dataset_params
            w = int(dp.window_size)
            bundle = common.unpack_data(
                ks_window_splits(*splits, window_size=w,
                                 data_normalizer=dp.data_normalizer),
                "simple")
            xn, yn = bundle["x_normalizer"], bundle["y_normalizer"]
            batch = cfg.training.batch_size
            train_loader, val_loader, _ = common.build_loaders(
                bundle, batch, False, seed=cfg.training.seed)
            trainer = common.build_trainer(cfg, common.build_model(cfg), yn,
                                           device="cuda")
            state = trainer.init()
            groups = state.optimizer.param_groups
            ratio = trainer.ssm_ratio
            require(len(groups) == 2, f"{mode}: optimizer groups {groups}")
            lrs = []

            def train_batches():
                # the state-space group's rate at every step
                for xb, yb in train_loader:
                    lrs.append((groups[0]["lr"], groups[1]["lr"]))
                    yield xb, yb

            ckpt, stalls = f"{tmp}/{cfg_name}", []

            def on_epoch(epoch, st, hist):
                t = time.perf_counter()
                save_checkpoint(ckpt, st, history={"train_loss":
                                                   hist.train_loss},
                                block=False)
                stalls.append((time.perf_counter() - t) * 1e3)

            state, hist = trainer.fit(
                state, train_batches, val_loader, epochs=S4_EPOCHS,
                schedule=common.build_schedule(cfg), epoch_callback=on_epoch)
            t = time.perf_counter()
            wait_for_checkpoints()
            drain_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            save_checkpoint(f"{tmp}/{cfg_name}_blocking", state)
            block_ms = (time.perf_counter() - t) * 1e3
            losses = hist.train_loss + hist.val_loss
            require(all(math.isfinite(v) for v in losses),
                    f"{mode}: non-finite losses {losses}")
            require(hist.train_loss[-1] < hist.train_loss[0],
                    f"{mode}: the train loss did not fall: {hist.train_loss}")
            require(len(lrs) == S4_EPOCHS * len(train_loader)
                    and all(s == ratio * m for m, s in lrs),
                    f"{mode}: the state-space rate is not {ratio} x the main "
                    f"rate at every step: {sorted(set(lrs))}")
            # a step's median on a fresh model (the trained one is served)
            fresh = common.build_trainer(cfg, common.build_model(cfg), yn,
                                         device="cuda")
            step_ms = _median_step_ms(fresh, fresh.init(), train_loader)
            del fresh
            log("s4_train", mode=mode, ssm_ratio=ratio,
                steps_per_epoch=len(train_loader),
                train_loss=[f"{v:.6f}" for v in hist.train_loss],
                val_loss=[f"{v:.6f}" for v in hist.val_loss],
                lr=hist.lr, epoch_s=[f"{v:.3f}" for v in hist.epoch_time_s],
                median_step_ms=f"{step_ms:.3f}",
                save_stall_ms_async=[f"{v:.2f}" for v in stalls],
                drain_ms=f"{drain_ms:.2f}",
                save_stall_ms_blocking=f"{block_ms:.2f}")

            # the sweep and the window rollout at every resolution
            def builder(res):
                red = [reduce_trajectories(u, reduced_resolution=KS_RES // res)
                       for u in splits]
                return ks_window_splits(*red, window_size=w,
                                        data_normalizer=False)[2]

            sweep = evaluate_all_resolutions(
                state.model, builder, current_res=KS_RES,
                test_resolutions=S4_RESOLUTIONS, x_normalizer=xn,
                y_normalizer=yn, batch_size=batch, strict=True)
            roll_s = {}
            roll = evaluate_rollout_all_resolutions(
                state.model, lambda res: splits[2][..., ::KS_RES // res],
                current_res=KS_RES, test_resolutions=S4_RESOLUTIONS,
                rollout_steps=cfg.dataset.rollout_steps, x_normalizer=xn,
                y_normalizer=yn, batch_size=batch, strict=True,
                window_size=w, seconds_out=roll_s)
            for name, res in (("sweep", sweep["results"]), ("rollout", roll)):
                require(sorted(res) == S4_RESOLUTIONS
                        and all(math.isfinite(v) for v in res.values()),
                        f"{mode}: {name} {res}")
            log("s4_train", mode=mode,
                sweep={r: f"{v:.6f}" for r, v in sweep["results"].items()},
                sweep_s={r: f"{v:.3f}" for r, v in sweep["seconds"].items()},
                rollout={r: f"{v:.6f}" for r, v in roll.items()},
                rollout_s={r: f"{v:.3f}" for r, v in roll_s.items()})

            # serve the checkpoint on the kernels' route through graphs
            cls, kw = model_kwargs(cfg.model, kernel_impl="pallas")
            per_call = {kname: S4["n_layers"], other: 0}
            eng = ServingEngine.from_checkpoint(
                cls(**kw, generator=torch.Generator().manual_seed(SEED + 1)),
                ckpt, None, device="cuda", x_normalizer=xn, y_normalizer=yn)
            warm_graphs(eng, [(n, S4_BATCH) for n in S4_LENGTHS], counters,
                        per_call, f"s4_{mode} from_checkpoint",
                        in_channels=w)
            ref_eng = ServingEngine(state.model, device="cuda",
                                    x_normalizer=xn, y_normalizer=yn)
            ref_eng.warmup(S4_LENGTHS, [S4_BATCH], in_channels=w)
            requests = {n: builder(n).x[:S4_BATCH] for n in S4_LENGTHS}
            # the main path: every count from here comes from requests
            cauchy.launches = vandermonde.launches = 0
            executed = 0
            outs = {}
            for n, x in requests.items():
                outs[n], ex = graph_executions(
                    lambda x=x: eng.predict(x), per_call, 1,
                    f"s4_{mode} served checkpoint at L {n}")
                executed += ex[kname]
            require(counters() == {"K4": 0, "K5": 0},
                    f"{mode}: the served checkpoint launched {counters()} "
                    "from the host")
            launched[mode] = executed
            for n, x in requests.items():
                got = outs[n]
                ref = eager(eng, lambda x=x: eng.predict(x))
                jnp_ref = ref_eng.predict(x)
                err = rel_l2(torch.from_numpy(got), torch.from_numpy(jnp_ref))
                log("s4_train", mode=mode, served=f"{S4_BATCH}x{n}",
                    graph_vs_eager_max_abs=f"{np.abs(got - ref).max():.3e}",
                    bit_equal=bool(np.array_equal(got, ref)),
                    vs_jnp_route_rel_l2=f"{err:.3e}", tol=1e-4)
                require(got.shape == (S4_BATCH, 1, n)
                        and np.isfinite(got).all(),
                        f"{mode}: served output {got.shape} or non-finite")
                require(rel_l2(torch.from_numpy(got), torch.from_numpy(ref))
                        <= 1e-6, f"{mode}: graph replay vs eager at L {n}")
                require(err <= 1e-4, f"{mode}: served checkpoint vs the jnp "
                        f"route at L {n}: {err}")
            log("s4_train", mode=mode, **{f"executions_{kname}": executed})
    log("s4_train", phase_seconds=f"{time.perf_counter() - t_phase:.2f}")
    return launched


# FFNO1D on generated KS (configs/model/ffno_1d.yaml, dataset/
# ks_naive_true_mres1.yaml, training/default.yaml, depth cut to
# FFNO1D_EPOCHS epochs): KS_GEN trajectories at KS_RES points from the
# port's generator (visc 0.075, L 64, lmax 8, et 5, KS_FRAMES snapshots),
# split as generate_data splits them
KS_GEN, KS_VISC = 64, 0.075
FFNO1D_EPOCHS = 2
FFNO1D_ROUTE = ["model.dropout=0", "model.ff_impl=fused"]
FFNO1D_SERVE = (128, 256, 512)


def generate_ks_on_card() -> dict:
    """The port's generate_ks array part on the card: KS_GEN trajectories
    of KS_FRAMES snapshots at KS_RES points. Checks that they are finite,
    within the solver's amplitude bound, and that consecutive frames
    correlate above 0.8 (learnable Markov pairs)."""
    from resolution_pde_tpu_torch.cli.generate_data import (
        generate_ks_arrays)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrays = generate_ks_arrays(KS_GEN, [KS_RES], KS_FRAMES, SEED,
                                viscosity=KS_VISC, device="cuda")
    seconds = time.perf_counter() - t0
    u = arrays["by_res"][KS_RES]
    peak, ic_peak = float(np.abs(u).max()), float(np.abs(u[:, 0]).max())
    amp_bound = max(10.0 / math.sqrt(KS_VISC), 1.5 * ic_peak)
    a, b = u[:, :-1].astype(np.float64), u[:, 1:].astype(np.float64)
    corr = float(((a * b).sum(-1) / np.sqrt((a * a).sum(-1)
                                            * (b * b).sum(-1))).mean())
    steps = int(round(arrays["snap_dt"] / (0.05 * KS_VISC))) * (KS_FRAMES
                                                                 - 1)
    log("ks_gen", shape=u.shape, split=arrays["split_counts"],
        snap_dt=f"{arrays['snap_dt']:.5f}", solver_steps=steps,
        seconds=f"{seconds:.2f}", ms_per_step=f"{seconds * 1e3 / steps:.3f}",
        max_abs=f"{peak:.3f}", bound=f"{amp_bound:.3f}",
        consecutive_corr=f"{corr:.4f}")
    # the solver through its CUDA graph (the generator's route) against
    # the same steps launched one by one: equal bits; both timed, and the
    # eager steps under the profiler (the launch-bound case the graph is for)
    from resolution_pde_tpu_torch.datagen.ks import solve_ks

    u0 = torch.as_tensor(u[:, 0], device="cuda")
    spb = steps // (KS_FRAMES - 1)
    kw = dict(visc=KS_VISC, dt=0.05 * KS_VISC, n_snapshots=6,
              steps_per_snapshot=spb)
    walls = {}
    for graph in (True, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve_ks(u0, graph=graph, **kw)
        torch.cuda.synchronize()
        walls.setdefault(graph, []).append(
            (time.perf_counter() - t0) * 1e3 / (5 * spb))
        if graph is False:
            eager_out = out
        elif graph and len(walls[True]) == 1:
            graph_out = out
    require(torch.equal(graph_out, eager_out),
            "KS solver: the CUDA graph's steps differ from eager ones")
    require(torch.equal(graph_out[:, 5], torch.as_tensor(u[:, 5],
                                                         device="cuda")),
            "KS solver: the generator's snapshot 5 differs from a re-solve")
    _, prof = profiled(lambda: solve_ks(u0, graph=False, **dict(
        kw, n_snapshots=2)))
    busy_ms, idle = _idle_share(prof)
    n_kernels = len(_device_kernels(prof))
    log("ks_gen", graph_vs_eager="bit_equal",
        ms_per_step_graph="/".join(f"{v:.4f}" for v in walls[True]),
        ms_per_step_eager=f"{walls[False][0]:.4f}", profiled_eager_steps=spb,
        device_busy_ms_per_step=f"{busy_ms / spb:.4f}",
        kernels_per_step=f"{n_kernels / spb:.1f}",
        device_idle_share_eager=f"{idle:.4f}")
    require(bool(np.isfinite(u).all()) and peak <= amp_bound,
            f"generated KS: max|u| {peak} (bound {amp_bound}) or non-finite")
    require(corr > 0.8, f"generated KS: consecutive frames correlate "
            f"{corr} <= 0.8")
    return arrays


def _ffno1d_run(name, argv, arrays, counters) -> dict:
    """main_1d's path, composed from cli.common's parts as main_1d composes
    them, on the generated arrays held as the KS files generate_data would
    write (cli.generate_data.ks_in_memory): the dataset factory of the
    config (the tree's train file through ks_true_multires_markov_dataset),
    FFNO1D_EPOCHS epochs of Trainer.fit, the test loss, and the sweep and
    16-step rollout at S4_RESOLUTIONS through cli.common's builders (the
    eval swap to ks_markov_dataset on the tree's 512-point files).
    Returns the run's record."""
    from resolution_pde_tpu_torch.cli import common
    from resolution_pde_tpu_torch.cli.generate_data import ks_in_memory
    from resolution_pde_tpu_torch.configs import (instantiate_dataset,
                                                  parse_cli)
    from resolution_pde_tpu_torch.evaluation import (
        evaluate_all_resolutions, evaluate_rollout_all_resolutions)

    cfg = parse_cli(argv)
    u = arrays["by_res"][KS_RES]
    n_tr, n_va, n_te = arrays["split_counts"]
    files = (u[:n_tr], u[n_tr:n_tr + n_va], u[n_tr + n_va:])

    def in_memory():
        return ks_in_memory(cfg.dataset.dataset_params.saved_folder, arrays,
                            KS_FRAMES)

    with in_memory():
        bundle = common.unpack_data(
            instantiate_dataset(cfg.dataset.dataset_params),
            cfg.dataset.dataset_params.normalization_type)
    xn, yn = bundle["x_normalizer"], bundle["y_normalizer"]
    batch = cfg.training.batch_size
    train_loader, val_loader, test_loader = common.build_loaders(
        bundle, batch, cfg.dataset.train_mres, seed=cfg.training.seed)
    trainer = common.build_trainer(cfg, common.build_model(cfg), yn,
                                   device="cuda")
    state = trainer.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = counters()
    state, hist = trainer.fit(state, train_loader, val_loader,
                              epochs=FFNO1D_EPOCHS,
                              schedule=common.build_schedule(cfg))
    fit = {k: counters()[k] - before[k] for k in before}
    test_loss = trainer.evaluate(state, test_loader)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20

    with in_memory():
        sweep = evaluate_all_resolutions(
            state.model, common.make_superres_builder(cfg),
            current_res=KS_RES, test_resolutions=S4_RESOLUTIONS,
            x_normalizer=xn, y_normalizer=yn, batch_size=batch, strict=True)
        roll_s = {}
        roll = evaluate_rollout_all_resolutions(
            state.model, common.make_rollout_builder(cfg, bundle["rollout"]),
            current_res=KS_RES, test_resolutions=S4_RESOLUTIONS,
            rollout_steps=cfg.dataset.rollout_steps, x_normalizer=xn,
            y_normalizer=yn, batch_size=batch, strict=True,
            seconds_out=roll_s)
    total = {k: counters()[k] - before[k] for k in before}
    losses = hist.train_loss + hist.val_loss + [test_loss]
    require(all(math.isfinite(v) for v in losses),
            f"ffno1d run {name}: non-finite losses {losses}")
    require(hist.train_loss[-1] < hist.train_loss[0],
            f"ffno1d run {name}: the train loss did not fall: "
            f"{hist.train_loss}")
    for what, res in (("sweep", sweep["results"]), ("rollout", roll)):
        require(sorted(res) == S4_RESOLUTIONS
                and all(math.isfinite(v) for v in res.values()),
                f"ffno1d run {name}: {what} {res}")
    # a fresh model's median step, and 10 steps under the profiler: the
    # device's busy time a step, its idle share and its largest kernels
    fresh = common.build_trainer(cfg, common.build_model(cfg), yn,
                                 device="cuda")
    fresh_state = fresh.init()
    step_ms = _median_step_ms(fresh, fresh_state, train_loader)

    def ten_steps():
        for i, (x, y) in enumerate(train_loader):
            if i == 10:
                break
            fresh.train_step(fresh_state, x, y)

    _, prof = profiled(ten_steps)
    busy_ms, idle = _idle_share(prof)
    by_kernel = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                                 + e.time_range.end - e.time_range.start)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
    del fresh, fresh_state
    log("ffno1d", run=name, profiled_steps=10,
        device_busy_ms_per_step=f"{busy_ms / 10:.3f}",
        device_idle_share=f"{idle:.4f}",
        top_kernels_ms_per_step={n[:48]: f"{v / 1e4:.3f}" for n, v in top})
    log("ffno1d", run=name, steps_per_epoch=len(train_loader),
        batch=f"{batch}x1x{KS_RES}",
        train_loss=[f"{v:.6f}" for v in hist.train_loss],
        val_loss=[f"{v:.6f}" for v in hist.val_loss],
        test_loss=f"{test_loss:.6f}",
        epoch_s=[f"{v:.3f}" for v in hist.epoch_time_s],
        median_step_ms=f"{step_ms:.3f}",
        max_memory_allocated_mb=f"{peak_mb:.1f}",
        sweep={r: f"{v:.6f}" for r, v in sweep["results"].items()},
        sweep_s={r: f"{v:.3f}" for r, v in sweep["seconds"].items()},
        rollout={r: f"{v:.6f}" for r, v in roll.items()},
        rollout_s={r: f"{v:.3f}" for r, v in roll_s.items()},
        fit_launches=fit, launches=total)
    return dict(cfg=cfg, state=state, bundle=bundle, files=files, fit=fit,
                total=total, steps=FFNO1D_EPOCHS * len(train_loader),
                val_batches=FFNO1D_EPOCHS * len(val_loader))


def run_ffno1d() -> dict:
    """FFNO1D from the KS generator to serving, at ffno_1d.yaml's width
    (128, 4 layers, 64 modes, factor 4, 3 FeedForward layers, LayerNorm,
    weight norm, exact GELU) on ks_naive_true_mres1.yaml's data path,
    batch 16: the KS trajectories generated on the card
    (generate_ks_on_card); run A, the yaml as shipped (dropout 0.2, the
    dense FeedForward, f32), which launches no kernel; run B on the kernel
    route (FFNO1D_ROUTE: K1f and K1b in f32, 4 of each a train step). B's
    trained model on the card against the same weights on the CPU through
    the plain versions at 512 and 64 points, and A's weights in the fused
    route against A's dense one on the card (1e-4). Then B's checkpoint
    served through ServingEngine.from_checkpoint in FFNO1D(ff_impl=
    'fused'), graphs at 16 x FFNO1D_SERVE: replay against the same engine
    run eagerly (bit for bit), K1f executing 4 times a replay, the median
    predict graph and eager. Returns B's launches and the served
    executions, and the generated KS under "ks_arrays"."""
    import copy

    from resolution_pde_tpu_torch.configs import model_kwargs
    from resolution_pde_tpu_torch.deploy import ServingEngine
    from resolution_pde_tpu_torch.ops.kernels import fused_ff
    from resolution_pde_tpu_torch.train import save_checkpoint

    t_phase = time.perf_counter()
    arrays = generate_ks_on_card()
    base = ["model=ffno_1d", "dataset=ks_naive_true_mres1",
            f"training.epochs={FFNO1D_EPOCHS}"]

    def counters():
        return {"K1f": fused_ff.launches, "K1b": fused_ff.bwd_launches}

    a = _ffno1d_run("A", base, arrays, counters)
    require(all(v == 0 for v in a["total"].values()),
            f"ffno1d run A (the yaml config) launched kernels: {a['total']}")
    b = _ffno1d_run("B", base + FFNO1D_ROUTE, arrays, counters)
    layers = b["cfg"].model.n_layers
    want_fit = {"K1f": layers * (b["steps"] + b["val_batches"]),
                "K1b": layers * b["steps"]}
    require(b["fit"] == want_fit, f"ffno1d run B: Trainer.fit launched "
            f"{b['fit']}, expected {want_fit} ({layers} a step each)")

    # B on the card against the same weights on the CPU (plain versions);
    # A's weights on the fused route against A's dense route on the card
    test = b["bundle"]["test"].buckets[KS_RES]
    x512 = torch.as_tensor(test.x[:S4_BATCH], device="cuda")
    model_b = b["state"].model.eval()
    cpu_b = copy.deepcopy(model_b).cpu()
    cls, kw = model_kwargs(a["cfg"].model, dropout=0.0, ff_impl="fused")
    fused_a = cls(**kw).cuda().eval()
    fused_a.load_state_dict(a["state"].model.state_dict())
    model_a = a["state"].model.eval()
    errs = {}
    with torch.inference_mode():
        for n in (KS_RES, 64):
            x = x512[..., ::KS_RES // n].contiguous()
            errs[f"B_card_vs_cpu_{n}"] = rel_l2(model_b(x).cpu(),
                                                cpu_b(x.cpu()))
            errs[f"A_fused_vs_dense_{n}"] = rel_l2(fused_a(x), model_a(x))
    log("ffno1d", agreement={k: f"{v:.3e}" for k, v in errs.items()},
        tol=1e-4)
    require(all(v <= 1e-4 for v in errs.values()),
            f"ffno1d agreement: {errs}")
    del cpu_b, fused_a

    # B's checkpoint served through graphs
    xn, yn = b["bundle"]["x_normalizer"], b["bundle"]["y_normalizer"]
    launched = {"fwd": b["total"]["K1f"], "bwd": b["total"]["K1b"],
                "served": 0}
    per_call = {"K1f": layers}
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(f"{tmp}/ffno1d_B", b["state"])
        cls, kw = model_kwargs(b["cfg"].model, ff_impl="fused")
        eng = ServingEngine.from_checkpoint(
            cls(**kw, generator=torch.Generator().manual_seed(SEED + 2)),
            f"{tmp}/ffno1d_B", None, device="cuda", x_normalizer=xn,
            y_normalizer=yn)
    warm_graphs(eng, [(n, S4_BATCH) for n in FFNO1D_SERVE], counters,
                per_call, "ffno1d from_checkpoint")
    raw_test = b["files"][2]
    requests = {n: np.ascontiguousarray(
        raw_test[:, :-1, ::KS_RES // n].reshape(-1, 1, n)[:S4_BATCH])
        for n in FFNO1D_SERVE}
    fused_ff.launches = fused_ff.bwd_launches = 0
    outs = {}
    for n, x in requests.items():
        outs[n], ex = graph_executions(
            lambda x=x: eng.predict(x), per_call, 1,
            f"ffno1d served checkpoint at {S4_BATCH} x {n}")
        launched["served"] += ex["K1f"]
    require(counters() == {"K1f": 0, "K1b": 0},
            f"ffno1d: the served checkpoint launched {counters()} from the "
            "host")
    for n, x in requests.items():
        got = outs[n]
        ref = eager(eng, lambda x=x: eng.predict(x))
        require(got.shape == (S4_BATCH, 1, n) and np.isfinite(got).all(),
                f"ffno1d: served output {got.shape} or non-finite")
        require(np.array_equal(got, ref),
                f"ffno1d: graph replay differs from eager at {n}")
        g1 = median_ms(lambda x=x: eng.predict(x))
        e1 = eager(eng, lambda x=x: median_ms(lambda: eng.predict(x)))
        g2 = median_ms(lambda x=x: eng.predict(x))
        log("ffno1d", served=f"{S4_BATCH}x{n}", bit_equal=True,
            median_ms_graph=f"{g1:.3f}/{g2:.3f}",
            median_ms_eager=f"{e1:.3f}")
    log("ffno1d", executions_K1f=launched["served"],
        phase_seconds=f"{time.perf_counter() - t_phase:.2f}")
    launched["ks_arrays"] = arrays  # for phase 15's KS legs
    return launched


# the flagship's command line (resolution_pde_tpu/configs/model/ffno_2d.yaml
# and dataset/ns_naive.yaml, training/default.yaml): a synthetic vorticity
# file of NS_TRAJ trajectories x NS_FRAMES frames at NS_RES^2
NS_TRAJ, NS_FRAMES, NS_RES, NS_MODES = 32, 20, 256, 16
CLI_RESOLUTIONS = [32, 64, 128, 256]
# bench.py:73-110's settings: the four bf16 kernels of the flagship
KERNEL_ROUTE = ["model.dropout=0", "model.compute_dtype=bfloat16",
                "model.spectral_impl=pallas2", "model.ff_impl=fused",
                "model.approx_gelu=true"]


def write_vorticity(folder: str) -> str:
    """A synthetic stand-in for the NS vorticity file, not NS physics:
    smooth random fields (Fourier modes |k| <= NS_MODES, from SEED)
    advected by one constant velocity and diffused, evolved exactly in
    Fourier space, so one frame to the next is one fixed linear map (a
    per-mode phase and decay). Written as .h5 where h5py is installed,
    else as a MATLAB .mat of u laid out (b, h, w, t), which read_ns reads
    too. Returns the file name."""
    import importlib.util

    rng = np.random.default_rng(SEED)
    n = NS_RES
    ky = np.fft.fftfreq(n, 1.0 / n)[:, None]
    kx = np.fft.rfftfreq(n, 1.0 / n)[None, :]
    keep = (ky ** 2 + kx ** 2) <= NS_MODES ** 2
    coef = (rng.standard_normal((NS_TRAJ, n, n // 2 + 1))
            + 1j * rng.standard_normal((NS_TRAJ, n, n // 2 + 1))) * keep
    # 1.5 and -0.75 grid cells a frame; mode NS_MODES decays by e^-0.1
    step = np.exp(-2j * np.pi * (1.5 * kx - 0.75 * ky) / n
                  - 0.1 * (kx ** 2 + ky ** 2) / NS_MODES ** 2)
    u = np.empty((NS_TRAJ, NS_FRAMES, n, n), np.float32)
    for t in range(NS_FRAMES):
        u[:, t] = np.fft.irfft2(coef * step ** t, s=(n, n))
    u /= u[:, 0].std()
    if importlib.util.find_spec("h5py") is not None:
        import h5py

        with h5py.File(f"{folder}/ns_synthetic.h5", "w") as f:
            f.create_dataset("u", data=u)
        return "ns_synthetic.h5"
    from scipy.io import savemat

    savemat(f"{folder}/ns_synthetic.mat",
            {"u": np.ascontiguousarray(np.transpose(u, (0, 2, 3, 1)))})
    return "ns_synthetic.mat"


def check_fft_path(gen) -> None:
    """The torch.fft spectral conv (spectral_impl 'fft', the yaml config's
    route) on the card against the CPU at the CLI's widths, 128² and 256²
    with 64 modes, FFNO1D's conv at 16 x {32, 64, 512} x 128 with 64
    modes (the Nyquist bin kept at 32 and 64), the FFT resize 256² ->
    128² (a Nyquist bin that
    is not real), each within 1e-4; the port's irfft against the CPU over
    24 to 32,768 rows at n = 128 with complex DC and Nyquist bins (within
    1e-4) beside torch.fft.irfft's own reading on the card (logged: cuFFT
    reads those bins' imaginary parts at some shapes, the CPU does not);
    the port's irfftn at S4ND's padded shape likewise, beside
    torch.fft.irfftn's own reading."""
    from resolution_pde_tpu_torch.ops.resize import fft_resize_2d
    from resolution_pde_tpu_torch.ops.spectral import (
        factorized_spectral_conv_1d, factorized_spectral_conv_2d, irfft,
        irfftn, spectral_conv_1d, spectral_conv_2d)

    for n in (128, 256):
        x = randn((2, n, n, WIDTH), gen, device="cpu")
        wy, wx = (randn((WIDTH, WIDTH, MODES, 2), gen, 0.05, device="cpu")
                  for _ in range(2))
        want = factorized_spectral_conv_2d(x, wy, wx, MODES)
        got = factorized_spectral_conv_2d(x.cuda(), wy.cuda(), wx.cuda(),
                                          MODES)
        err = rel_l2(got.cpu(), want)
        log("fft_path", grid=f"2x{n}^2x{WIDTH}", modes=MODES,
            card_vs_cpu_rel_l2=f"{err:.3e}", tol=1e-4)
        require(err <= 1e-4, f"fft spectral conv at {n}^2 on the card vs "
                f"the CPU: {err}")
    # FFNO1D's conv at ffno_1d.yaml's width and modes: all 17 and 33
    # bins, the Nyquist bin among them, at 32 and 64 points
    w1 = randn((WIDE, WIDE, MODES, 2), gen, 0.05, device="cpu")
    for n in (32, 64, KS_RES):
        x = randn((S4_BATCH, n, WIDE), gen, device="cpu")
        err = rel_l2(factorized_spectral_conv_1d(x.cuda(), w1.cuda(),
                                                 MODES).cpu(),
                     factorized_spectral_conv_1d(x, w1, MODES))
        log("fft_path", conv_1d=f"{S4_BATCH}x{n}x{WIDE}", modes=MODES,
            kept=min(MODES, n // 2 + 1), card_vs_cpu_rel_l2=f"{err:.3e}",
            tol=1e-4)
        require(err <= 1e-4, f"fft 1D conv at {n} on the card vs the CPU: "
                f"{err}")
    # FNO's convs at fno_1d.yaml's width and modes (16 of 17 bins at 32)
    # and fno_2d.yaml's (both corners; at 24² with 13 column modes the
    # corners meet and the Nyquist column, complex after the mix, is kept)
    w1 = randn((64, 64, 16, 2), gen, 0.05, device="cpu")
    for n in (32, 1024):
        x = randn((S4_BATCH, 64, n), gen, device="cpu")
        err = rel_l2(spectral_conv_1d(x.cuda(), w1.cuda(), 16).cpu(),
                     spectral_conv_1d(x, w1, 16))
        log("fft_path", fno_conv_1d=f"{S4_BATCH}x64x{n}", modes=16,
            card_vs_cpu_rel_l2=f"{err:.3e}", tol=1e-4)
        require(err <= 1e-4, f"FNO 1D conv at {n} on the card vs the CPU: "
                f"{err}")
    for n, m1, m2 in ((32, 12, 12), (64, 12, 12), (128, 12, 12),
                      (24, 12, 13)):
        x = randn((4, 32, n, n), gen, device="cpu")
        wa, wb = (randn((32, 32, m1, m2, 2), gen, 0.05, device="cpu")
                  for _ in range(2))
        err = rel_l2(spectral_conv_2d(x.cuda(), wa.cuda(), wb.cuda(), m1,
                                      m2).cpu(),
                     spectral_conv_2d(x, wa, wb, m1, m2))
        log("fft_path", fno_conv_2d=f"4x32x{n}^2", modes=(m1, m2),
            card_vs_cpu_rel_l2=f"{err:.3e}", tol=1e-4)
        require(err <= 1e-4, f"FNO 2D conv at {n}^2 modes {(m1, m2)} on "
                f"the card vs the CPU: {err}")
    x = randn((16, 1, RES, RES), gen, device="cpu")
    err = rel_l2(fft_resize_2d(x.cuda(), (128, 128)).cpu(),
                 fft_resize_2d(x, (128, 128)))
    log("fft_path", resize=f"16x{RES}^2->128^2",
        card_vs_cpu_rel_l2=f"{err:.3e}", tol=1e-4)
    require(err <= 1e-4, f"fft_resize_2d on the card vs the CPU: {err}")
    raw, port = {}, {}
    for rows in (24, 4096, 32768):
        z = torch.complex(randn((rows, 65), gen, device="cpu"),
                          randn((rows, 65), gen, device="cpu"))
        want = torch.fft.irfft(z, n=128)
        raw[rows] = rel_l2(torch.fft.irfft(z.cuda(), n=128).cpu(), want)
        port[rows] = rel_l2(irfft(z.cuda(), 128).cpu(), want)
    log("fft_path", n=128, bins=65, torch_irfft_card_vs_cpu=
        {r: f"{v:.3e}" for r, v in raw.items()},
        port_irfft_card_vs_cpu={r: f"{v:.3e}" for r, v in port.items()})
    require(max(port.values()) <= 1e-4, f"ops.spectral.irfft: {port}")
    # S4ND's inverse: a spectrum of its padded shape at the 128² train
    # (batch 8, d_model 64, 2 x 128 by 2 x 128), every bin complex as the
    # product of the input's and the kernels' spectra leaves them
    shape = (S4ND_BATCH, S4ND_WIDTH, 2 * S4ND_RES, S4ND_RES + 1)
    z = torch.complex(randn(shape, gen, device="cpu"),
                      randn(shape, gen, device="cpu"))
    s = (2 * S4ND_RES, 2 * S4ND_RES)
    want = irfftn(z, s)
    raw = rel_l2(torch.fft.irfftn(z.cuda(), s=s).cpu(), want)
    port = rel_l2(irfftn(z.cuda(), s).cpu(), want)
    log("fft_path", irfftn="x".join(map(str, shape)), s=s,
        torch_irfftn_card_vs_cpu=f"{raw:.3e}",
        port_irfftn_card_vs_cpu=f"{port:.3e}", tol=1e-4)
    require(port <= 1e-4, f"ops.spectral.irfftn on the card vs the CPU: "
            f"{port}")


def _idle_share(prof) -> tuple:
    """(device busy ms, idle share) over the window from the first device
    event to the last: the union of the device intervals (kernels, copies
    and fills; not the ranges that user annotations such as the
    optimizer's step span on the device's timeline)."""
    dev = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.time_range.start)
    require(bool(dev), "the profiler recorded no device events")
    start, end = dev[0].time_range.start, max(e.time_range.end for e in dev)
    busy, cur_s, cur_e = 0.0, None, None
    for e in dev:
        s, t = e.time_range.start, e.time_range.end
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy += cur_e - cur_s
    return busy / 1e3, 1.0 - busy / (end - start)


def _top_kernels(prof, steps: int) -> dict:
    """The profile's six largest kernels by device time, ms a step."""
    by_name = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if t > 0:
            by_name[e.key[:60]] = t / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {k: f"{v:.3f}" for k, v in top}


def _cli_parts(argv, ckpt):
    """The CLI's config, data bundle, loaders and a Trainer whose state is
    restored from the run's checkpoint: what main() builds, for the
    measurements beside the runs."""
    from resolution_pde_tpu_torch.cli import common
    from resolution_pde_tpu_torch.configs import (instantiate_dataset,
                                                  parse_cli)
    from resolution_pde_tpu_torch.train import restore_checkpoint

    argv = argv + ["training.scheduler=step"]
    cfg = parse_cli(argv)
    bundle = common.unpack_data(
        instantiate_dataset(cfg.dataset.dataset_params),
        cfg.dataset.dataset_params.normalization_type)
    loaders = common.build_loaders(bundle, cfg.training.batch_size, False,
                                   seed=cfg.training.seed)
    trainer = common.build_trainer(cfg, common.build_model(cfg),
                                   bundle["y_normalizer"], device="cuda")
    state, _ = restore_checkpoint(ckpt, trainer.init())
    return cfg, bundle, loaders, trainer, state


def _check_run(name, out):
    hist = out["history"].train_loss
    log("cli", run=name, train_loss=[f"{v:.6f}" for v in hist],
        val_loss=[f"{v:.6f}" for v in out["history"].val_loss],
        epoch_s=[f"{v:.3f}" for v in out["history"].epoch_time_s],
        test_loss=f"{out['test_loss']:.6f}",
        super_resolution={r: f"{v:.6f}"
                          for r, v in out["super_resolution"].items()},
        rollout={r: f"{v:.6f}" for r, v in out["rollout"].items()},
        eval_s={r: f"{v:.3f}" for r, v in out["eval_seconds"].items()},
        rollout_s={r: f"{v:.3f}" for r, v in out["rollout_seconds"].items()},
        platform=out["provenance"]["platform"])
    require(len(hist) == 2 and hist[1] < hist[0],
            f"run {name}: the train loss did not fall: {hist}")
    require(math.isfinite(out["test_loss"]),
            f"run {name}: test loss {out['test_loss']}")
    for key in ("super_resolution", "rollout"):
        got = out[key]
        require(sorted(got) == CLI_RESOLUTIONS
                and all(math.isfinite(v) for v in got.values()),
                f"run {name}: {key} {got}")
    require(out["provenance"]["platform"].startswith("cuda("),
            f"run {name}: platform {out['provenance']['platform']}")


def _median_step_ms(trainer, state, loader, steps=12, warm=2) -> float:
    times = []
    for i, (x, y) in enumerate(loader):
        if i == warm + steps:
            break
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, loss = trainer.train_step(state, x, y)
        torch.cuda.synchronize()
        if i >= warm:
            times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def run_cli() -> dict:
    """The flagship's command line as a user runs it: main_2d's main(argv)
    with its override strings, in a temporary working directory (the CLI
    writes checkpoints/ and runs/ there), on a synthetic vorticity file
    (write_vorticity). Run A: the yaml configs as shipped (width 64, 4
    layers, 64 modes, dropout 0.1, torch.fft, the dense FeedForward, f32,
    batch 16, 256^2, the sweep to 256, 16 rollout steps), 2 epochs. Run
    B: the same on bench.py's kernel route (KERNEL_ROUTE), whose launches
    of K1f, K1b, K2 and its adjoint are counted (all four at least once).
    Run C: the plain f32 route warm-started from B's checkpoint with 0
    epochs; the first test batch's predictions of both at each
    resolution within relative L2 3e-2. Then each run's median step, the
    loader's host ms a batch, and one epoch of run B under torch.profiler
    for the device's idle share. Returns B's launches."""
    cwd = os.getcwd()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            launched = _run_cli_in(tmp)
        finally:
            os.chdir(cwd)
    log("cli", phase_seconds=f"{time.perf_counter() - t_phase:.2f}")
    return launched


def _run_cli_in(tmp: str) -> dict:
    from resolution_pde_tpu_torch.cli import (autoregressive_eval, common,
                                              frequency_evaluation)
    from resolution_pde_tpu_torch.cli.main_2d import main as main_2d
    from resolution_pde_tpu_torch.evaluation.superres import (
        normalized_forward)
    from resolution_pde_tpu_torch.ops.kernels import fused_ff, spectral_mix

    t0 = time.perf_counter()
    fname = write_vorticity(tmp)
    log("cli", data=f"{tmp}/{fname}",
        shape=(NS_TRAJ, NS_FRAMES, NS_RES, NS_RES),
        what="synthetic stand-in (advected, diffused random fields), "
             "not NS physics",
        seconds=f"{time.perf_counter() - t0:.2f}")
    base = ["model=ffno_2d", "dataset=ns_naive",
            f"dataset.dataset_params.saved_folder={tmp}",
            f"dataset.dataset_params.filename={fname}"]
    runs = {"A": base + ["training.epochs=2"],
            "B": base + KERNEL_ROUTE + ["training.epochs=2"]}
    outs, launched = {}, {}
    for name, argv in runs.items():
        os.makedirs(f"{tmp}/{name}")
        os.chdir(f"{tmp}/{name}")
        # the main path: every launch counted here comes from main()
        fused_ff.launches = fused_ff.bwd_launches = 0
        spectral_mix.launches = spectral_mix.adjoint_launches = 0
        spectral_mix.wide_launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs[name] = main_2d(argv)
        launched[name] = dict(zip(("fwd", "bwd", "k2", "adj"),
                                  _counts()))
        launched[name]["staged"] = spectral_mix.wide_launches
        log("cli", run=name, seconds=f"{time.perf_counter() - t0:.2f}",
            max_memory_allocated_mb=
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f}",
            launches=launched[name])
        _check_run(name, outs[name])
    require(all(v == 0 for v in launched["A"].values()),
            f"run A (the yaml config) launched kernels: {launched['A']}")
    b = launched["B"]
    require(all(b[k] >= 1 for k in ("fwd", "bwd", "k2", "adj")),
            f"run B launched K1f, K1b, K2, K2 adj {b}")
    require(b["staged"] == b["k2"] + b["adj"],
            f"run B: {b['staged']} of {b['k2'] + b['adj']} spectral "
            "launches on the staged route")

    # the evaluation CLIs on run B's checkpoint and file, on its route:
    # the sweep and the rollout must repeat what main_2d printed
    ckpt_b = os.path.abspath(f"{tmp}/B/{outs['B']['checkpoint']}")
    os.makedirs(f"{tmp}/eval")
    os.chdir(f"{tmp}/eval")
    eval_argv = runs["B"] + [f"dataset.saved_checkpoint_path={ckpt_b}"]
    before = _counts()
    t0 = time.perf_counter()
    ev = autoregressive_eval.main(eval_argv)
    t_ev = time.perf_counter() - t0
    freq = frequency_evaluation.main(eval_argv)
    t_freq = time.perf_counter() - t0 - t_ev
    d = dict(zip(("fwd", "bwd", "k2", "adj"),
                 (a - b for a, b in zip(_counts(), before))))
    for key, got in (("super_resolution", ev["teacher_forcing"]),
                     ("rollout", ev["rollout"])):
        want = outs["B"][key]
        require(sorted(got) == sorted(want) and all(
            abs(got[r] - want[r]) <= 1e-6 * abs(want[r]) for r in want),
            f"autoregressive_eval's {key} {got} vs main_2d's {want}")
    err = freq["default"]["error_per_mode"]
    require(np.isfinite(err).all() and np.isfinite(
        freq["default"]["magnitude_per_mode"]).all(),
        "frequency_evaluation: non-finite table")
    require(d["fwd"] >= 1 and d["k2"] >= 1,
            f"the eval CLIs launched K1f and K2 {d}")
    for k in ("fwd", "k2"):
        launched["B"][k] += d[k]
    launched["B"]["staged"] += d["k2"]
    log("cli", eval_clis="autoregressive_eval, frequency_evaluation on run "
        "B's checkpoint", seconds=f"{t_ev:.2f}/{t_freq:.2f}",
        teacher_forcing={r: f"{v:.6f}" for r, v in ev["teacher_forcing"]
                         .items()},
        rollout={r: f"{v:.6f}" for r, v in ev["rollout"].items()},
        total_err=f"{np.linalg.norm(err):.6f}", launches=d,
        equal_to_main_2d="1e-6")

    # run C: the plain route from B's weights, through the warm start
    os.makedirs(f"{tmp}/C")
    os.chdir(f"{tmp}/C")
    plain = base + ["model.dropout=0", "model.approx_gelu=true"]
    out_c = main_2d(plain + ["training.epochs=0",
                             f"dataset.saved_checkpoint_path={ckpt_b}"])
    log("cli", run="C", test_loss=f"{out_c['test_loss']:.6f}",
        super_resolution={r: f"{v:.6f}"
                          for r, v in out_c["super_resolution"].items()})
    cfg, bundle, loaders_b, trainer_b, state_b = _cli_parts(
        runs["B"], ckpt_b)
    _, _, _, trainer_c, state_c = _cli_parts(
        plain, os.path.abspath(f"{tmp}/C/{out_c['checkpoint']}"))
    sd_b, sd_c = state_b.model.state_dict(), state_c.model.state_dict()
    require(sd_b.keys() == sd_c.keys()
            and all(torch.equal(sd_b[k], sd_c[k]) for k in sd_b),
            "run C's warm start did not carry run B's weights")
    builder = common.make_superres_builder(cfg)
    errs = {}
    with torch.inference_mode():
        for res in CLI_RESOLUTIONS:
            ds = builder(res)
            bx = torch.as_tensor(ds.x[:cfg.training.batch_size],
                                 device="cuda")
            preds = [normalized_forward(
                st.model.eval(), bx, bundle["x_normalizer"].to("cuda"),
                bundle["y_normalizer"].to("cuda"), 2)
                for st in (state_b, state_c)]
            errs[res] = rel_l2(preds[0].float(), preds[1].float())
    log("cli", b_vs_plain_first_test_batch_rel_l2=
        {r: f"{v:.3e}" for r, v in errs.items()}, tol=3e-2)
    require(all(v <= 3e-2 for v in errs.values()),
            f"run B's predictions vs the plain f32 path: {errs}")

    # beside the runs: median steps, the loader's host time, and one
    # epoch of run B under the profiler
    train_a = _cli_parts(runs["A"], os.path.abspath(
        f"{tmp}/A/{outs['A']['checkpoint']}"))
    step_a = _median_step_ms(train_a[3], train_a[4], train_a[2][0])
    del train_a
    step_b = _median_step_ms(trainer_b, state_b, loaders_b[0])
    t0 = time.perf_counter()
    n = sum(1 for _ in loaders_b[0])
    loader_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, prof = profiled(lambda: trainer_b.train_epoch(state_b, loaders_b[0]))
    busy_ms, idle = _idle_share(prof)
    log("cli", median_step_ms_A=f"{step_a:.3f}",
        median_step_ms_B=f"{step_b:.3f}",
        loader_host_ms_per_batch=f"{loader_ms:.3f}", batches=n,
        batch=f"{cfg.training.batch_size}x1x{NS_RES}^2",
        profiled_epoch_B_s=f"{time.perf_counter() - t0:.3f}",
        device_busy_ms=f"{busy_ms:.1f}", device_idle_share=f"{idle:.4f}")
    return launched["B"]


# phase 13: NS generated on the card (generate_data pde=ns's settings:
# 26 snapshots, viscosity 1e-03, dt 1e-3), then the ns_models family's
# ffno2d_ns leg through cli.sweep on that file
NS_GEN, NS_GEN_FRAMES, NS_VISC = 16, 26, "1e-03"


def generate_ns_on_card(folder: str) -> tuple:
    """The port's generate_data pde=ns on the card: NS_GEN trajectories of
    NS_GEN_FRAMES snapshots at NS_RES², each finite with a spatial mean
    of zero (the initial fields and the forcing have none), timed; the
    solver's CUDA graph against its steps launched one by one (bit for
    bit) and against the CPU (64², 2 trajectories, 50 steps, relative L2
    1e-4), each from the same initial condition; the data written as the
    .mat file the NS factories read without h5py. Returns its name and
    generate_ns_arrays' output."""
    from resolution_pde_tpu_torch.cli.generate_data import (
        generate_ns_arrays, write_ns)
    from resolution_pde_tpu_torch.datagen import (GaussianRF,
                                                  navier_stokes_2d,
                                                  ns_forcing)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrays = generate_ns_arrays(NS_GEN, [NS_RES], NS_GEN_FRAMES, SEED,
                                viscosity=NS_VISC, device="cuda")
    seconds = time.perf_counter() - t0
    u = arrays["by_res"][NS_RES]
    scale = float(np.abs(u).max())
    mean = float(np.abs(u.astype(np.float64).mean(axis=(2, 3))).max())
    steps = NS_GEN_FRAMES * int(round(0.1 / 1e-3))
    log("ns_gen", shape=u.shape, steps=steps, seconds=f"{seconds:.2f}",
        ms_per_step=f"{seconds * 1e3 / steps:.3f}", max_abs=f"{scale:.4f}",
        max_abs_spatial_mean=f"{mean:.3e}", t_last=f"{arrays['t'][-1]:.3f}")
    require(u.shape == (NS_GEN, NS_GEN_FRAMES, NS_RES, NS_RES)
            and bool(np.isfinite(u).all()) and 0 < scale < 100,
            f"generated NS: shape {u.shape}, max|w| {scale} or non-finite")
    require(mean <= 1e-4 * scale,
            f"generated NS: spatial mean {mean} of a field of max {scale}")

    # the graph against eager steps on the card, timed as the difference
    # between 10 and 2 snapshots of 100 steps (a solve captures its graph
    # first, which takes longer than 200 steps and varies more), at
    # NS_GEN x NS_RES²; then the card against the CPU
    grf = GaussianRF(2, NS_RES, alpha=2.5, tau=7.0)
    w0 = grf.sample(torch.Generator().manual_seed(SEED + 1), NS_GEN, "cuda")
    f = ns_forcing(NS_RES)
    kw = dict(visc=float(NS_VISC), delta_t=1e-3)
    walls, outs = {}, {}
    for graph in (True, False, True):
        wall = []
        for snaps in (2, 10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = navier_stokes_2d(w0, f, T=snaps * 0.1, record_steps=snaps,
                                   graph=graph, **kw)[0]
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        outs.setdefault(graph, sol)
        walls.setdefault(graph, []).append((wall[1] - wall[0]) * 1e3 / 800)
    require(torch.equal(outs[True], outs[False]),
            "NS solver: the CUDA graph's steps differ from eager ones")
    _, prof = profiled(lambda: navier_stokes_2d(
        w0, f, graph=False, T=0.02, record_steps=1, **kw))
    busy_ms, idle = _idle_share(prof)
    w_small = GaussianRF(2, 64, alpha=2.5, tau=7.0).sample(
        torch.Generator().manual_seed(SEED + 2), 2)
    kw_small = dict(visc=float(NS_VISC), T=0.05, delta_t=1e-3,
                    record_steps=2, f=ns_forcing(64))
    card_sol = navier_stokes_2d(w_small.cuda(), **kw_small)[0].cpu()
    cpu_sol = navier_stokes_2d(w_small, **kw_small)[0]
    err = rel_l2(card_sol, cpu_sol)
    log("ns_gen", graph_vs_eager="bit_equal",
        ms_per_step_graph="/".join(f"{v:.4f}" for v in walls[True]),
        ms_per_step_eager=f"{walls[False][0]:.4f}",
        device_busy_ms_per_step=f"{busy_ms / 20:.4f}",
        kernels_per_step=f"{len(_device_kernels(prof)) / 20:.1f}",
        device_idle_share_eager=f"{idle:.4f}",
        card_vs_cpu_64=f"{err:.3e}", tol=1e-4)
    require(err <= 1e-4, f"NS solver: card vs CPU relative L2 {err}")
    t0 = time.perf_counter()
    [path] = write_ns(folder, arrays, file_format="mat")
    log("ns_gen", wrote=path, seconds=f"{time.perf_counter() - t0:.2f}")
    return os.path.basename(path), arrays


def run_ns_sweep() -> dict:
    """NS generated on the card (generate_ns_on_card), then cli.sweep
    family=ns_models only=ffno2d_ns training.epochs=1 on that .mat file, in
    a temporary working directory (_sweep_leg): ffno_2d.yaml and
    ns_naive.yaml as shipped (the 256² file strided to 128², 8 rollout
    steps), which launch no hand kernel; the sweep and rollout at
    CLI_RESOLUTIONS. Returns generate_ns_arrays' output."""
    import contextlib

    cwd = os.getcwd()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            fname, arrays = generate_ns_on_card(f"{tmp}/data")
            leg, launched, _ = _sweep_leg(
                "ns_models", "ffno2d_ns",
                [f"dataset.dataset_params.saved_folder={tmp}/data",
                 f"dataset.dataset_params.filename={fname}"],
                contextlib.nullcontext())
        finally:
            os.chdir(cwd)
    require(all(sorted(leg[k]) == CLI_RESOLUTIONS
                for k in ("super_resolution", "rollout")),
            f"ns_sweep: sweep {leg['super_resolution']}, rollout "
            f"{leg['rollout']}")
    require(not any(launched),
            f"ns_sweep: the yaml config launched kernels {launched}")
    log("ns_sweep", phase_seconds=f"{time.perf_counter() - t_phase:.2f}")
    return arrays  # the generated NS, for phase 15


# phase 14: Burgers and Darcy generated on the card (generate_data's
# settings: 100 steps of dt 1e-4 a snapshot, viscosity 0.001; Darcy at
# 128², beta 0.01), then the legs of the baseline, burger_ladder and darcy
# families that run on them, through cli.sweep
BURGERS_GEN, BURGERS_FRAMES, BURGERS_VISC = 64, 11, 0.001
BURGERS_RESOLUTIONS = [1024, 512, 256, 128]
DARCY_GEN, DARCY_RES = 64, 128
SWEEP_RESOLUTIONS_1D = [32, 64, 128, 256, 512, 1024]


def generate_burgers_on_card() -> dict:
    """The port's generate_data pde=burgers array part on the card:
    BURGERS_GEN trajectories of BURGERS_FRAMES snapshots at each of
    BURGERS_RESOLUTIONS (solved at that grid), finite and within the
    maximum principle (1.05 x the initial peak), timed; at 1024 points
    the solver's CUDA graph against its steps launched one by one (bit
    for bit, both equal to the generator's snapshots), and the card
    against the CPU on the first 4 trajectories (relative L2 1e-5)."""
    from resolution_pde_tpu_torch.cli.generate_data import (
        generate_burgers_arrays)
    from resolution_pde_tpu_torch.datagen.burgers import solve_burgers

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrays = generate_burgers_arrays(BURGERS_GEN, BURGERS_RESOLUTIONS,
                                     BURGERS_FRAMES, SEED,
                                     viscosity=BURGERS_VISC, device="cuda")
    seconds = time.perf_counter() - t0
    steps = (BURGERS_FRAMES - 1) * 100
    peaks = {}
    for res, u in arrays["by_res"].items():
        peaks[res] = (float(np.abs(u).max()), float(np.abs(u[:, 0]).max()))
        require(u.shape == (BURGERS_GEN, BURGERS_FRAMES, res)
                and bool(np.isfinite(u).all())
                and peaks[res][0] <= 1.05 * peaks[res][1],
                f"generated Burgers at {res}: shape {u.shape}, max|u| "
                f"{peaks[res]} or non-finite")
    log("burgers_gen", resolutions=BURGERS_RESOLUTIONS,
        trajectories=BURGERS_GEN, snapshots=BURGERS_FRAMES,
        steps_per_resolution=steps, seconds=f"{seconds:.2f}",
        ms_per_step=f"{seconds * 1e3 / (steps * len(peaks)):.4f}",
        max_abs={r: f"{p[0]:.4f}" for r, p in peaks.items()},
        initial_max_abs={r: f"{p[1]:.4f}" for r, p in peaks.items()})
    u = arrays["by_res"][BURGERS_RESOLUTIONS[0]]
    u0 = torch.as_tensor(u[:, 0], device="cuda")
    kw = dict(nu=BURGERS_VISC, dt=1e-4, n_snapshots=3,
              steps_per_snapshot=100)
    walls, outs = {}, {}
    for graph in (True, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve_burgers(u0, graph=graph, **kw)
        torch.cuda.synchronize()
        walls.setdefault(graph, []).append(
            (time.perf_counter() - t0) * 1e3 / 200)
        outs.setdefault(graph, out)
    require(torch.equal(outs[True], outs[False]),
            "Burgers solver: the CUDA graph's steps differ from eager ones")
    require(np.array_equal(outs[True].cpu().numpy(), u[:, :3]),
            "Burgers solver: a re-solve differs from the generator's "
            "snapshots")
    err = rel_l2(outs[True][:4].cpu(), solve_burgers(u0[:4].cpu(), **kw))
    log("burgers_gen", graph_vs_eager="bit_equal",
        ms_per_step_graph="/".join(f"{v:.4f}" for v in walls[True]),
        ms_per_step_eager=f"{walls[False][0]:.4f}",
        card_vs_cpu_1024=f"{err:.3e}", tol=1e-5)
    require(err <= 1e-5, f"Burgers solver: card vs CPU relative L2 {err}")
    return arrays


def generate_darcy_on_card() -> dict:
    """The port's generate_data pde=darcy array part on the card:
    DARCY_GEN samples at DARCY_RES² (beta 0.01, batches of 32): the
    coefficients 3 or 12, the solutions finite and positive, each batch's
    CG iterations and largest relative residual beside the gate, timed;
    the card's CG against the CPU's on 4 samples at 32² (relative L2
    1e-4)."""
    from resolution_pde_tpu_torch.cli.generate_data import (
        generate_darcy_arrays)
    from resolution_pde_tpu_torch.datagen.darcy import solve_darcy

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrays = generate_darcy_arrays(DARCY_GEN, [DARCY_RES], SEED,
                                   device="cuda")
    seconds = time.perf_counter() - t0
    d = arrays["by_res"][DARCY_RES]
    cg = arrays["cg"][DARCY_RES]
    log("darcy_gen", shape=d["u"].shape, beta=arrays["beta"],
        seconds=f"{seconds:.2f}", cg_iterations=[c[0] for c in cg],
        max_relative_residual=f"{max(c[1] for c in cg):.3e}", gate=1e-2,
        u_range=f"[{d['u'].min():.3e}, {d['u'].max():.3e}]")
    require(set(np.unique(d["a"])) == {3.0, 12.0}
            and bool(np.isfinite(d["u"]).all()) and d["u"].min() > 0
            and max(c[1] for c in cg) <= 1e-2,
            f"generated Darcy: coefficients {np.unique(d['a'])}, u range "
            f"[{d['u'].min()}, {d['u'].max()}], CG {cg}")
    a = torch.as_tensor(d["a"][:4, ::4, ::4])
    err = rel_l2(solve_darcy(a.cuda(), beta=0.01).cpu(),
                 solve_darcy(a, beta=0.01))
    log("darcy_gen", cg_card_vs_cpu_32=f"{err:.3e}", tol=1e-4)
    require(err <= 1e-4, f"Darcy CG: card vs CPU relative L2 {err}")
    return arrays


def _sweep_leg(family: str, leg: str, argv, context) -> tuple:
    """cli.sweep family=<family> only=<leg> training.epochs=1 <argv>, in
    the working directory, inside ``context`` (the generated arrays held
    as the files generate_data writes): the leg green with a finite test
    loss and sweep (and rollout where it has one), sweep.csv and sweep.md
    written with platform cuda(...), no .ok (a subset of the family) and
    no .incomplete. Returns (the leg's
    record, the kernels' launches in it (K1f, K1b, K2, K2 adjoint), its
    table row)."""
    import csv

    from resolution_pde_tpu_torch.cli import sweep

    before = _counts()
    t0 = time.perf_counter()
    with context:
        out = sweep.main([f"family={family}", f"only={leg}",
                          "training.epochs=1", *argv])[leg]
    seconds = time.perf_counter() - t0
    launched = [a - b for a, b in zip(_counts(), before)]
    # each leg's family differs, so its run directory is the only one
    # named after it
    [run_dir] = [f"runs/sweeps/{d}" for d in os.listdir("runs/sweeps")
                 if d.startswith(f"{family}_")]
    files = sorted(os.listdir(run_dir))
    with open(f"{run_dir}/sweep.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    with open(f"{run_dir}/sweep.md") as f:
        md = f.read()
    log("sweep_leg", leg=f"{family}/{leg}", seconds=f"{seconds:.2f}",
        files=files, launches=launched,
        row={k: v for k, v in rows[0].items() if k != "checkpoint"})
    require(out is not None, f"sweep leg {family}/{leg} failed: "
            f"{rows[0]['error'] if rows else '?'}")
    require(math.isfinite(out["test_loss"]) and all(
        math.isfinite(v) for k in ("super_resolution", "rollout")
        for v in out[k].values()),
        f"sweep leg {leg}: test {out['test_loss']}, sweep "
        f"{out['super_resolution']}, rollout {out['rollout']}")
    require(files == ["sweep.csv", "sweep.md"] and len(rows) == 1
            and rows[0]["platform"].startswith("cuda(")
            and rows[0]["error"] == "" and rows[0]["legs_green"] == "1/1"
            and "| cuda(" in md,
            f"sweep leg {leg}: files {files}, table {rows}")
    return out, launched, rows[0]


def fno1d_step() -> None:
    """FNO1d at fno_1d.yaml's width (64, 4 blocks, 16 modes) on random
    batches of 16 x 1 x 1024 (burger_naive.yaml's grid and
    training/default.yaml's batch): the median Trainer step, and over 10
    profiled steps the device's busy time a step and its idle share."""
    from resolution_pde_tpu_torch.cli import common
    from resolution_pde_tpu_torch.configs import parse_cli
    from resolution_pde_tpu_torch.data.dataset import ArrayDataset
    from resolution_pde_tpu_torch.data.loader import Loader

    cfg = parse_cli(["model=fno_1d", "dataset=burger_naive"])
    x = np.random.default_rng(SEED).standard_normal(
        (320, 1, BURGERS_RESOLUTIONS[0])).astype(np.float32)
    loader = Loader(ArrayDataset(x, np.roll(x, 3, axis=-1)),
                    cfg.training.batch_size, shuffle=True)
    trainer = common.build_trainer(cfg, common.build_model(cfg), None,
                                   device="cuda")
    state = trainer.init()
    step_ms = _median_step_ms(trainer, state, loader)

    def ten_steps():
        for i, (xb, yb) in enumerate(loader):
            if i == 10:
                break
            trainer.train_step(state, xb, yb)

    _, prof = profiled(ten_steps)
    busy_ms, idle = _idle_share(prof)
    log("fno1d_step", batch=f"{cfg.training.batch_size}x1x"
        f"{BURGERS_RESOLUTIONS[0]}", median_step_ms=f"{step_ms:.3f}",
        device_busy_ms_per_step=f"{busy_ms / 10:.3f}",
        kernels_per_step=f"{len(_device_kernels(prof)) / 10:.1f}",
        device_idle_share=f"{idle:.4f}")


def run_burgers_darcy() -> dict:
    """Burgers and Darcy generated on the card (generate_burgers_on_card,
    generate_darcy_on_card), then, in a temporary working directory
    holding them as the files generate_data writes under data/
    (cli.generate_data.burgers_in_memory, darcy_in_memory; the yaml
    files' relative folders), three legs through cli.sweep for 1 epoch:
    the baseline family's fno1d_burger_naive (fno_1d.yaml, burger_naive
    .yaml as shipped: 1024 points, the sweep at 32 ... 1024, the rollout),
    the burger_ladder's ffno1d_burger_naive_true_mres on FFNO1D's kernel
    route (dropout 0, ff_impl 'fused': K1f and K1b in f32, each launched
    at least 4 times a step; the true multi-resolution folders at 1024,
    512, 256 and 128, the extra resolutions 64 and 32 strided from 1024),
    and the darcy family's fno2d_darcy (fno_2d.yaml, darcy.yaml, 128²);
    before them FNO1d's train step (fno1d_step). The FNO legs launch no
    hand kernel. Returns the Burgers FFNO1D leg's
    launches of K1f and K1b."""
    from resolution_pde_tpu_torch.cli.generate_data import (
        burgers_in_memory, darcy_in_memory)

    t_phase = time.perf_counter()
    burgers = generate_burgers_on_card()
    darcy = generate_darcy_on_card()
    fno1d_step()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            fno1d, fno1d_k, _ = _sweep_leg(
                "baseline", "fno1d_burger_naive", [],
                burgers_in_memory("data/burgers", burgers))
            folder = f"burgers_{BURGERS_RESOLUTIONS[0]}_{BURGERS_VISC}"
            ffno1d, ffno1d_k, _ = _sweep_leg(
                "burger_ladder", "ffno1d_burger_naive_true_mres",
                [*FFNO1D_ROUTE,
                 "dataset.dataset_params.saved_folder=data/burgers",
                 "dataset.dataset_params.eval_saved_folder="
                 f"data/burgers/{folder}"],
                burgers_in_memory("data/burgers", burgers))
            fno2d, fno2d_k, _ = _sweep_leg(
                "darcy", "fno2d_darcy", [],
                darcy_in_memory("data/darcy", darcy))
        finally:
            os.chdir(cwd)
    for name, out, want in (("fno1d", fno1d, SWEEP_RESOLUTIONS_1D),
                            ("ffno1d", ffno1d, SWEEP_RESOLUTIONS_1D),
                            ("fno2d", fno2d, [32, 64, 128])):
        require(sorted(out["super_resolution"]) == want,
                f"{name} leg: sweep at {sorted(out['super_resolution'])}")
    require(sorted(fno1d["rollout"]) == sorted(ffno1d["rollout"])
            == SWEEP_RESOLUTIONS_1D and not fno2d["rollout"],
            f"rollouts: {fno1d['rollout']}, {ffno1d['rollout']}, "
            f"{fno2d['rollout']}")
    require(not any(fno1d_k) and not any(fno2d_k),
            f"the FNO legs launched kernels: {fno1d_k}, {fno2d_k}")
    layers = 4  # ffno_1d.yaml's n_layers
    require(ffno1d_k[0] >= layers and ffno1d_k[1] >= layers
            and not any(ffno1d_k[2:]),
            f"the FFNO1D Burgers leg launched {ffno1d_k} (K1f, K1b, K2, "
            "K2 adjoint)")
    log("burgers_darcy", ffno1d_K1f_f32=ffno1d_k[0],
        ffno1d_K1b_f32=ffno1d_k[1], train_seconds={
            "fno1d": f"{fno1d['train_seconds']:.2f}",
            "ffno1d": f"{ffno1d['train_seconds']:.2f}",
            "fno2d": f"{fno2d['train_seconds']:.2f}"},
        phase_seconds=f"{time.perf_counter() - t_phase:.2f}")
    return {"fwd": ffno1d_k[0], "bwd": ffno1d_k[1]}


# phase 15: CNO, UNet and the active-matter path through cli.sweep, 1 epoch
# a leg: ns_models' cno2d_ns_resize and cno2d_original_ns (cno_2d.yaml and
# cno_2d_original.yaml: 4 levels, multiplier 32, trained at 128²) on phase
# 13's NS, the baseline's cno2d_ns_resize at 256², ks_models' cno_1d and
# unet_1d legs on phase 12's KS, ns_active_ladder's ffno2d_ns_active_t2 on
# phase 13's NS split over four files in the Well's layout; CNO2d's step,
# its forward against the CPU, a resume held to a tolerance (its
# antialiased resize's backward adds with atomics on the card) and serving
CNO_BATCH, CNO_SERVE_BATCH = 16, 4
CNO_RESUME_TOL = 1e-4


def _leg_in_dir(root: str, family: str, leg: str, argv, context) -> tuple:
    """_sweep_leg in a working directory of its own under ``root``, so
    that two legs of one family each find their one run directory.
    Returns _sweep_leg's record and launches, and the leg's checkpoint as
    an absolute path."""
    leg_dir = os.path.join(root, f"{family}__{leg}")
    os.makedirs(leg_dir)
    cwd = os.getcwd()
    os.chdir(leg_dir)
    try:
        out, launched, _ = _sweep_leg(family, leg, argv, context)
        ckpt = os.path.abspath(out["checkpoint"])
    finally:
        os.chdir(cwd)
    return out, launched, ckpt


def _cno2d(size: int):
    """CNO2d at cno_2d.yaml's widths (4 levels, 4 residual blocks a level
    and in the neck, multiplier 32) built for ``size``, its parameters
    drawn from training.seed (0): (the config, the model)."""
    from resolution_pde_tpu_torch.cli import common
    from resolution_pde_tpu_torch.configs import parse_cli

    cfg = parse_cli(["model=cno_2d", "dataset=ns_naive",
                     f"dataset.cno_train_size={size}"])
    return cfg, common.build_model(cfg)


def cno2d_step(size: int) -> dict:
    """CNO2d's Trainer step at CNO_BATCH x size² on random batches: the
    median step, the device's busy time a step, its idle share and the six
    kernels that take the most of it over 5 profiled steps, and the peak
    memory of a step."""
    from resolution_pde_tpu_torch.cli import common

    cfg, model = _cno2d(size)
    trainer = common.build_trainer(cfg, model, None, device="cuda")
    state = trainer.init()
    gen = torch.Generator().manual_seed(SEED + size)
    batches = [(torch.randn(CNO_BATCH, 1, size, size, generator=gen),
                torch.randn(CNO_BATCH, 1, size, size, generator=gen))
               for _ in range(2)]
    loader = [batches[i % 2] for i in range(12)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = _median_step_ms(trainer, state, loader, steps=10, warm=2)
    peak = torch.cuda.max_memory_allocated() / 2**30

    def five_steps():
        for x, y in loader[:5]:
            trainer.train_step(state, x, y)

    _, prof = profiled(five_steps)
    busy_ms, idle = _idle_share(prof)
    rec = dict(batch=f"{CNO_BATCH}x1x{size}x{size}",
               median_step_ms=f"{step_ms:.3f}",
               device_busy_ms_per_step=f"{busy_ms / 5:.3f}",
               kernels_per_step=f"{len(_device_kernels(prof)) / 5:.1f}",
               device_idle_share=f"{idle:.4f}",
               peak_memory_gib=f"{peak:.2f}",
               top_kernels_ms_per_step=_top_kernels(prof, 5))
    log("cno_step", **rec)
    return rec


def cno2d_card_vs_cpu() -> None:
    """CNO2d at cno_2d.yaml's widths built for 128², one set of weights
    and BatchNorm statistics, on the card and on the CPU (f32,
    TF32 off): the forward of a batch of 2 in eval and in train mode,
    relative L2 1e-4, and the running statistics the train-mode forward
    leaves, 1e-4."""
    import copy

    _, cpu = _cno2d(128)
    with torch.no_grad():
        for _, buf in cpu.named_buffers():
            buf.add_(0.1 * torch.rand(buf.shape,
                                      generator=torch.Generator()
                                      .manual_seed(SEED + 1)))
    card = copy.deepcopy(cpu).cuda()
    x = torch.randn(2, 1, 128, 128,
                    generator=torch.Generator().manual_seed(SEED + 2))
    errs = {}
    with torch.no_grad():
        for mode in ("eval", "train"):
            cpu.train(mode == "train")
            card.train(mode == "train")
            errs[mode] = rel_l2(card(x.cuda()).cpu(), cpu(x))
    stats = max(rel_l2(b_card.cpu(), b_cpu) for (_, b_card), (_, b_cpu)
                in zip(card.named_buffers(), cpu.named_buffers()))
    log("cno_card_vs_cpu", size="2x1x128x128", eval=f"{errs['eval']:.3e}",
        train=f"{errs['train']:.3e}", running_stats=f"{stats:.3e}",
        tol=1e-4)
    require(max(errs.values()) <= 1e-4 and stats <= 1e-4,
            f"CNO2d card vs CPU: forward {errs}, running stats {stats}")


def cno2d_resume() -> None:
    """CNO2d at 128² (cno_2d.yaml's widths, batch CNO_BATCH): 4 Trainer
    steps, against 2 steps, a checkpoint, and 2 steps from it restored
    into a fresh Trainer: the restored parameters and BatchNorm buffers
    equal the saved ones bit for bit, the last two losses within
    CNO_RESUME_TOL relative (the resize's backward adds with atomics, so
    the card does not repeat CNO's steps bit for bit)."""
    from resolution_pde_tpu_torch.cli import common
    from resolution_pde_tpu_torch.train import (restore_checkpoint,
                                                save_checkpoint)

    gen = torch.Generator().manual_seed(SEED + 3)
    batches = [(torch.randn(CNO_BATCH, 1, 128, 128, generator=gen),
                torch.randn(CNO_BATCH, 1, 128, 128, generator=gen))
               for _ in range(4)]

    def trainer():
        cfg, model = _cno2d(128)
        t = common.build_trainer(cfg, model, None, device="cuda")
        return t, t.init()

    t, state = trainer()
    full = [float(t.train_step(state, *b)[1]) for b in batches]
    t, state = trainer()
    for b in batches[:2]:
        t.train_step(state, *b)
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, state)
        saved = {k: v.clone() for k, v in state.model.state_dict().items()}
        t2, state2 = trainer()
        state2, _ = restore_checkpoint(tmp, state2)
    require(all(torch.equal(v, saved[k])
                for k, v in state2.model.state_dict().items()),
            "CNO2d resume: the restored state differs from the saved one")
    resumed = [float(t2.train_step(state2, *b)[1]) for b in batches[2:]]
    err = max(abs(a - b) / abs(b) for a, b in zip(resumed, full[2:]))
    log("cno_resume", losses=[f"{v:.7f}" for v in full],
        resumed=[f"{v:.7f}" for v in resumed], max_rel_diff=f"{err:.3e}",
        tol=CNO_RESUME_TOL, bit_equal=resumed == full[2:])
    require(err <= CNO_RESUME_TOL, f"CNO2d resume: losses {resumed} "
            f"against {full[2:]}")


def serve_cno2d(ckpt: str) -> None:
    """The trained ns_models CNO2d (128²) from its checkpoint through
    ServingEngine: a graph at CNO_SERVE_BATCH x 128², a request of
    CNO_SERVE_BATCH - 1 (padded), the replay equal to the same engine run
    eagerly bit for bit, the median predict graphed and eager."""
    from resolution_pde_tpu_torch.deploy import ServingEngine

    _, model = _cno2d(128)
    eng = ServingEngine.from_checkpoint(model, ckpt, device="cuda")
    t0 = time.perf_counter()
    eng.warmup(spatial_shapes=[(128, 128)], batch_sizes=[CNO_SERVE_BATCH])
    capture_s = time.perf_counter() - t0
    x = np.random.default_rng(SEED).standard_normal(
        (CNO_SERVE_BATCH - 1, 1, 128, 128)).astype(np.float32)
    got = eng.predict(x)
    ref = eager(eng, lambda: eng.predict(x))
    require(got.shape == x.shape and bool(np.isfinite(got).all()),
            f"CNO2d served: {got.shape} or non-finite")
    require(np.array_equal(got, ref),
            "CNO2d served: the graph replay differs from eager")
    g = median_ms(lambda: eng.predict(x))
    e = eager(eng, lambda: median_ms(lambda: eng.predict(x)))
    log("cno_serve", bucket=f"{CNO_SERVE_BATCH}x128x128", request=x.shape[0],
        capture_s=f"{capture_s:.3f}", bit_equal=True,
        median_ms_graph=f"{g:.3f}", median_ms_eager=f"{e:.3f}")


def run_cno(ns_arrays: dict, ks_arrays: dict) -> None:
    """Phase 15, through cli.sweep for 1 epoch a leg, each leg in a
    working directory of its own: ns_models' cno2d_ns_resize and
    cno2d_original_ns on phase 13's NS (.mat, the 256² file strided to
    128²; use_resize sweep and 8-step rollout through the resize round
    trip), the baseline's cno2d_ns_resize on it at 256² (resize training
    at the file's own size), ks_models' cno_1d_ks_naive and
    unet_1d_ks_naive on phase 12's KS (held as generate_data's files,
    cli.generate_data.ks_in_memory; 512 points), and ns_active_ladder's
    ffno2d_ns_active_t2 on phase 13's NS split over four files in the
    Well's layout (cli.generate_data.active_in_memory; ffno_2d.yaml as
    shipped). No leg launches a hand kernel. Then CNO2d's step at 128²
    and 256² (cno2d_step), its forward on the card against the CPU
    (cno2d_card_vs_cpu), a resume (cno2d_resume) and the trained 128²
    leg served (serve_cno2d)."""
    import contextlib

    from resolution_pde_tpu_torch.cli.generate_data import (
        active_in_memory, ks_in_memory, write_ns)

    t_phase = time.perf_counter()
    cwd = os.getcwd()
    legs = {}
    with tempfile.TemporaryDirectory() as tmp:
        [ns_path] = write_ns(f"{tmp}/data/ns", ns_arrays, file_format="mat")
        ns = [f"dataset.dataset_params.saved_folder={tmp}/data/ns",
              f"dataset.dataset_params.filename={os.path.basename(ns_path)}"]
        none = contextlib.nullcontext
        try:
            for family, leg in (("ns_models", "cno2d_ns_resize"),
                                ("ns_models", "cno2d_original_ns"),
                                ("baseline", "cno2d_ns_resize")):
                legs[f"{family}/{leg}"] = _leg_in_dir(tmp, family, leg, ns,
                                                      none())
            ks_dir = f"{tmp}/data/ks"
            for leg in ("cno_1d_ks_naive", "unet_1d_ks_naive"):
                legs[f"ks_models/{leg}"] = _leg_in_dir(
                    tmp, "ks_models", leg,
                    [f"dataset.dataset_params.saved_folder={ks_dir}"],
                    ks_in_memory(ks_dir, ks_arrays, KS_FRAMES))
            well = f"{tmp}/data/well"
            parts = np.array_split(ns_arrays["by_res"][NS_RES], 4)
            legs["ns_active_ladder/ffno2d_ns_active_t2"] = _leg_in_dir(
                tmp, "ns_active_ladder", "ffno2d_ns_active_t2",
                [f"dataset.dataset_params.saved_folder={well}"],
                active_in_memory(well, parts))
        finally:
            os.chdir(cwd)
        want_sweep = {"ns_models/cno2d_ns_resize": CLI_RESOLUTIONS,
                      "ns_models/cno2d_original_ns": CLI_RESOLUTIONS,
                      "baseline/cno2d_ns_resize": CLI_RESOLUTIONS,
                      "ks_models/cno_1d_ks_naive": SWEEP_RESOLUTIONS_1D[:5],
                      "ks_models/unet_1d_ks_naive": SWEEP_RESOLUTIONS_1D[:5],
                      "ns_active_ladder/ffno2d_ns_active_t2":
                          CLI_RESOLUTIONS}
        for name, (out, launched, _) in legs.items():
            require(sorted(out["super_resolution"]) == want_sweep[name],
                    f"{name}: sweep at {sorted(out['super_resolution'])}")
            require(not any(launched), f"{name} launched kernels {launched}")
        require(all(sorted(legs[n][0]["rollout"]) == want_sweep[n]
                    for n in want_sweep if "active" not in n)
                and not legs["ns_active_ladder/ffno2d_ns_active_t2"][0][
                    "rollout"],
                "phase 15 rollouts: " + str({n: sorted(r[0]["rollout"])
                                             for n, r in legs.items()}))
        log("cno", train_seconds={n: f"{r[0]['train_seconds']:.2f}"
                                  for n, r in legs.items()},
            test_loss={n: f"{r[0]['test_loss']:.6f}"
                       for n, r in legs.items()},
            params_m={n: f"{r[0]['n_params'] / 1e6:.2f}"
                      for n, r in legs.items()})
        serve_cno2d(legs["ns_models/cno2d_ns_resize"][2])
    for size in (128, 256):
        cno2d_step(size)
    cno2d_card_vs_cpu()
    cno2d_resume()
    log("cno", phase_seconds=f"{time.perf_counter() - t_phase:.2f}")



# phase 16: the transformer operators, which launch no hand kernel:
# ns_models' pos_ns leg (ScOT at the family's demo widths, 0.48 M
# parameters) through cli.sweep on phase 13's NS, main_2d model=mgpt
# dataset=ns_gnot on it strided to 32² (1,024-node point clouds, as the JAX
# demo), ScOT at pos.yaml's widths with one channel (101.3 M parameters):
# its Trainer step at 8 x 128² and its forward against the CPU, and the
# trained pos_ns ScOT served through graphs
SCOT_BATCH, SCOT_RES, SCOT_SERVE_BATCH = 8, 128, 4
GNOT_STRIDE = 8  # 256² -> 32²
SCOT_CPU_TOL = 1e-4


def _all_counts() -> tuple:
    """Every kernel entry's launch counter: _counts' and the S4 kernels'."""
    from resolution_pde_tpu_torch.ops.kernels import cauchy, vandermonde

    return _counts() + (vandermonde.launches, cauchy.launches)


def _scot(*overrides):
    """ScOT2d from pos.yaml with one input and output channel and
    ``overrides``, its parameters drawn from training.seed (0): (the
    config, the model)."""
    from resolution_pde_tpu_torch.cli import common
    from resolution_pde_tpu_torch.configs import parse_cli

    cfg = parse_cli(["model=pos", "dataset=ns_naive",
                     "model.num_channels=1", "model.num_out_channels=1",
                     *overrides])
    return cfg, common.build_model(cfg)


def scot_step() -> dict:
    """ScOT at pos.yaml's widths: the Trainer step at SCOT_BATCH x
    SCOT_RES² on random batches (median of 5 after 2 warm steps), the
    device's busy time, idle share and kernels a step over 3 profiled
    steps, the peak memory of a step."""
    from resolution_pde_tpu_torch.cli import common

    cfg, model = _scot()
    n_params = sum(p.numel() for p in model.parameters())
    trainer = common.build_trainer(cfg, model, None, device="cuda")
    state = trainer.init()
    gen = torch.Generator().manual_seed(SEED + 16)
    batches = [tuple(torch.randn(SCOT_BATCH, 1, SCOT_RES, SCOT_RES,
                                 generator=gen) for _ in range(2))
               for _ in range(2)]
    loader = [batches[i % 2] for i in range(7)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = _median_step_ms(trainer, state, loader, steps=5, warm=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = []

    def three_steps():
        for x, y in loader[:3]:
            losses.append(float(trainer.train_step(state, x, y)[1]))

    _, prof = profiled(three_steps)
    busy_ms, idle = _idle_share(prof)
    require(all(math.isfinite(v) for v in losses),
            f"ScOT step: losses {losses}")
    rec = dict(params_m=f"{n_params / 1e6:.2f}",
               batch=f"{SCOT_BATCH}x1x{SCOT_RES}x{SCOT_RES}",
               median_step_ms=f"{step_ms:.3f}",
               device_busy_ms_per_step=f"{busy_ms / 3:.3f}",
               kernels_per_step=f"{len(_device_kernels(prof)) / 3:.1f}",
               device_idle_share=f"{idle:.4f}",
               peak_memory_gib=f"{peak:.2f}",
               losses=[f"{v:.5f}" for v in losses])
    log("scot_step", **rec)
    require(round(n_params / 1e6, 1) == 101.3,
            f"ScOT at pos.yaml's widths: {n_params} parameters")
    return rec


def scot_card_vs_cpu() -> None:
    """ScOT at pos.yaml's widths, one set of weights on the card and on the
    CPU (f32, TF32 off): the forward of a batch of 2 at SCOT_RES² with a
    time a sample, relative L2 SCOT_CPU_TOL."""
    import copy

    _, cpu = _scot()
    card = copy.deepcopy(cpu).cuda()
    gen = torch.Generator().manual_seed(SEED + 17)
    x = torch.randn(2, 1, SCOT_RES, SCOT_RES, generator=gen)
    t = torch.tensor([0.5, 1.5])
    with torch.no_grad():
        want = cpu(x, t)["output"]
        got = card(x.cuda(), t.cuda())["output"].cpu()
    err = rel_l2(got, want)
    log("scot_card_vs_cpu", size=f"2x1x{SCOT_RES}x{SCOT_RES}",
        time=[0.5, 1.5], rel_l2=f"{err:.3e}", tol=SCOT_CPU_TOL)
    require(err <= SCOT_CPU_TOL, f"ScOT card vs CPU: relative L2 {err}")


def serve_scot(ckpt: str, overrides) -> None:
    """The trained pos_ns ScOT from its checkpoint through ServingEngine: a
    graph at SCOT_SERVE_BATCH x 128², a request of SCOT_SERVE_BATCH - 1
    (padded), the replay equal to the same engine run eagerly bit for bit,
    the median predict graphed and eager. The shift masks and position
    tables are made in the eager run before the capture."""
    from resolution_pde_tpu_torch.deploy import ServingEngine

    _, model = _scot(*overrides)
    eng = ServingEngine.from_checkpoint(model, ckpt, device="cuda")
    t0 = time.perf_counter()
    eng.warmup(spatial_shapes=[(128, 128)], batch_sizes=[SCOT_SERVE_BATCH])
    capture_s = time.perf_counter() - t0
    x = np.random.default_rng(SEED).standard_normal(
        (SCOT_SERVE_BATCH - 1, 1, 128, 128)).astype(np.float32)
    got = eng.predict(x)
    ref = eager(eng, lambda: eng.predict(x))
    require(got.shape == x.shape and bool(np.isfinite(got).all()),
            f"ScOT served: {got.shape} or non-finite")
    require(np.array_equal(got, ref),
            "ScOT served: the graph replay differs from eager")
    g = median_ms(lambda: eng.predict(x))
    e = eager(eng, lambda: median_ms(lambda: eng.predict(x)))
    log("scot_serve", bucket=f"{SCOT_SERVE_BATCH}x128x128",
        request=x.shape[0], capture_s=f"{capture_s:.3f}", bit_equal=True,
        median_ms_graph=f"{g:.3f}", median_ms_eager=f"{e:.3f}")


def gnot_run(root: str, ns: list) -> dict:
    """main_2d model=mgpt dataset=ns_gnot training.epochs=1 in a working
    directory of its own under ``root``, on phase 13's NS strided by
    GNOT_STRIDE: mgpt.yaml as shipped (GNOTOperator, n_hidden 64, 2
    layers); green with a finite test loss, no sweep and no rollout
    (ns_gnot.yaml has neither), no kernel launched."""
    from resolution_pde_tpu_torch.cli import main_2d

    work = os.path.join(root, "mgpt__ns_gnot")
    os.makedirs(work)
    cwd = os.getcwd()
    before = _all_counts()
    os.chdir(work)
    try:
        out = main_2d.main(["model=mgpt", "dataset=ns_gnot", *ns,
                            "dataset.dataset_params.reduced_resolution="
                            f"{GNOT_STRIDE}", "training.epochs=1"],
                           device="cuda")
    finally:
        os.chdir(cwd)
    launched = [a - b for a, b in zip(_all_counts(), before)]
    hist = out["history"]
    log("gnot", nodes=(NS_RES // GNOT_STRIDE) ** 2,
        params_m=f"{out['n_params'] / 1e6:.2f}",
        train_seconds=f"{out['train_seconds']:.2f}",
        train_loss=f"{hist.train_loss[0]:.6f}",
        val_loss=f"{hist.val_loss[0]:.6f}",
        test_loss=f"{out['test_loss']:.6f}", launches=launched,
        platform=out["provenance"]["platform"])
    require(math.isfinite(out["test_loss"]) and not out["super_resolution"]
            and not out["rollout"], f"GNOT run: {out['test_loss']}, sweep "
            f"{out['super_resolution']}, rollout {out['rollout']}")
    require(out["provenance"]["platform"].startswith("cuda("),
            f"GNOT run on {out['provenance']['platform']}")
    require(not any(launched), f"GNOT run launched kernels {launched}")
    return out


def run_transformers(ns_arrays: dict) -> None:
    """Phase 16: ns_models' pos_ns leg through cli.sweep for 1 epoch on
    phase 13's NS (.mat, the 256² file strided to 128²; the sweep and
    8-step rollout at CLI_RESOLUTIONS, where ScOT's second stage clamps
    its window at 32²), main_2d model=mgpt dataset=ns_gnot on it
    (gnot_run), each in a working directory of its own and launching no
    hand kernel; the trained pos_ns ScOT served (serve_scot); ScOT at
    pos.yaml's widths, its step (scot_step) and its forward against the
    CPU (scot_card_vs_cpu)."""
    import contextlib

    from resolution_pde_tpu_torch.cli import sweep
    from resolution_pde_tpu_torch.cli.generate_data import write_ns

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        [ns_path] = write_ns(f"{tmp}/data/ns", ns_arrays, file_format="mat")
        ns = [f"dataset.dataset_params.saved_folder={tmp}/data/ns",
              f"dataset.dataset_params.filename={os.path.basename(ns_path)}"]
        before = _all_counts()
        out, _, ckpt = _leg_in_dir(tmp, "ns_models", "pos_ns", ns,
                                   contextlib.nullcontext())
        launched = [a - b for a, b in zip(_all_counts(), before)]
        require(sorted(out["super_resolution"]) == CLI_RESOLUTIONS
                and sorted(out["rollout"]) == CLI_RESOLUTIONS,
                f"pos_ns: sweep {sorted(out['super_resolution'])}, rollout "
                f"{sorted(out['rollout'])}")
        require(not any(launched), f"pos_ns launched kernels {launched}")
        log("pos_ns", params_m=f"{out['n_params'] / 1e6:.2f}",
            train_seconds=f"{out['train_seconds']:.2f}",
            test_loss=f"{out['test_loss']:.6f}",
            super_resolution={r: f"{v:.6f}" for r, v in
                              sorted(out["super_resolution"].items())},
            rollout={r: f"{v:.6f}" for r, v in sorted(out["rollout"].items())})
        gnot_run(tmp, ns)
        [leg] = [a for n, _, a in sweep.FAMILIES["ns_models"] if n == "pos_ns"]
        serve_scot(ckpt, [a for a in leg if a.startswith("model.")])
    scot_step()
    scot_card_vs_cpu()
    log("transformers", phase_seconds=f"{time.perf_counter() - t_phase:.2f}")

# phase 17: S4ND and the S4 base/sequence family. main_2d model=s4_2d
# (s4_2d.yaml's widths: d_model 64, 4 layers, d_state 64, dropout 0.2,
# mode diag, the 'jnp' route) on phase 13's NS strided to 128², 1 epoch;
# its Trainer step at 8 x 128²; the trained S4ND served through graphs on
# K4 and a dplr S4ND at the same widths on K5, buckets 8 x {64, 128,
# 256}²; S4BaseSeqModel and S4DualSeqModel at their default widths, the
# convolution against the recurrence
S4ND_ARGV = ["model=s4_2d", "dataset=ns_naive", "model.d_input=1",
             "model.d_output=1", "dataset.dataset_params.reduced_resolution=2"]
S4ND_BATCH, S4ND_RES, S4ND_SERVE = 8, 128, (64, 128, 256)
S4ND_WIDTH = 64  # s4_2d.yaml's d_model; its layers' d_state is S4_STATE
S4ND_TOL = 1e-4
# the sequence models' default widths (models/s4_base.py) on B x T x S x V
SEQ_SHAPE, SEQ_RTOL, SEQ_ATOL = (2, 16, 32, 1), 2e-3, 2e-4


def _s4nd(*overrides, **kw):
    """S4NDModel from s4_2d.yaml with one input and output channel and
    ``overrides`` (the yaml's d_input 15 is the reference's unused width),
    its parameters drawn from training.seed (0), built with the keyword
    arguments ``kw`` (kernel_impl, mode): (the config, the model)."""
    from resolution_pde_tpu_torch.configs import instantiate_model, parse_cli

    cfg = parse_cli(S4ND_ARGV + list(overrides))
    return cfg, instantiate_model(cfg.model, seed=cfg.training.seed, **kw)


def s4nd_cli(root: str, ns: list) -> str:
    """main_2d model=s4_2d dataset=ns_naive (S4ND_ARGV) training.epochs=1
    in a working directory of its own under ``root``: trained at 128²,
    the sweep and 16-step rollout at CLI_RESOLUTIONS, each finite, no
    kernel launched (the 'jnp' route). Returns the checkpoint's path."""
    from resolution_pde_tpu_torch.cli import main_2d

    work = os.path.join(root, "s4_2d__ns_naive")
    os.makedirs(work)
    cwd = os.getcwd()
    before = _all_counts()
    os.chdir(work)
    try:
        out = main_2d.main(S4ND_ARGV + ns + ["training.epochs=1"],
                           device="cuda")
        ckpt = os.path.abspath(out["checkpoint"])
    finally:
        os.chdir(cwd)
    launched = [a - b for a, b in zip(_all_counts(), before)]
    hist = out["history"]
    log("s4nd_cli", params_m=f"{out['n_params'] / 1e6:.4f}",
        train_seconds=f"{out['train_seconds']:.2f}",
        train_loss=[f"{v:.6f}" for v in hist.train_loss],
        val_loss=[f"{v:.6f}" for v in hist.val_loss],
        test_loss=f"{out['test_loss']:.6f}",
        super_resolution={r: f"{v:.6f}" for r, v in
                          sorted(out["super_resolution"].items())},
        rollout={r: f"{v:.6f}" for r, v in sorted(out["rollout"].items())},
        launches=launched, platform=out["provenance"]["platform"])
    values = (list(hist.train_loss) + list(hist.val_loss) + [out["test_loss"]]
              + list(out["super_resolution"].values())
              + list(out["rollout"].values()))
    require(all(math.isfinite(v) for v in values),
            f"s4_2d run: non-finite losses {values}")
    require(sorted(out["super_resolution"]) == CLI_RESOLUTIONS
            and sorted(out["rollout"]) == CLI_RESOLUTIONS,
            f"s4_2d run: sweep {sorted(out['super_resolution'])}, rollout "
            f"{sorted(out['rollout'])}")
    require(out["provenance"]["platform"].startswith("cuda("),
            f"s4_2d run on {out['provenance']['platform']}")
    require(not any(launched), f"s4_2d ('jnp') launched kernels {launched}")
    return ckpt


def s4nd_step() -> dict:
    """S4ND at s4_2d.yaml's widths on the 'jnp' route: the Trainer step at
    S4ND_BATCH x S4ND_RES² on random batches (median of 10 after 2 warm
    steps), the device's busy time, idle share and kernels a step over 3
    profiled steps, the peak memory of a step; then its forward in eval
    mode on the card against the CPU on the same weights (2 x 128²)."""
    import copy

    from resolution_pde_tpu_torch.cli import common

    cfg, model = _s4nd()
    cpu = copy.deepcopy(model)
    n_params = sum(p.numel() for p in model.parameters())
    trainer = common.build_trainer(cfg, model, None, device="cuda")
    state = trainer.init()
    gen = torch.Generator().manual_seed(SEED + 17)
    batches = [tuple(torch.randn(S4ND_BATCH, 1, S4ND_RES, S4ND_RES,
                                 generator=gen) for _ in range(2))
               for _ in range(2)]
    loader = [batches[i % 2] for i in range(12)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = _median_step_ms(trainer, state, loader, steps=10, warm=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = []

    def three_steps():
        for x, y in loader[:3]:
            losses.append(float(trainer.train_step(state, x, y)[1]))

    _, prof = profiled(three_steps)
    busy_ms, idle = _idle_share(prof)
    require(all(math.isfinite(v) for v in losses),
            f"S4ND step: losses {losses}")
    rec = dict(params_m=f"{n_params / 1e6:.4f}",
               batch=f"{S4ND_BATCH}x1x{S4ND_RES}x{S4ND_RES}",
               median_step_ms=f"{step_ms:.3f}",
               device_busy_ms_per_step=f"{busy_ms / 3:.3f}",
               kernels_per_step=f"{len(_device_kernels(prof)) / 3:.1f}",
               device_idle_share=f"{idle:.4f}",
               peak_memory_gib=f"{peak:.2f}",
               top_kernels_ms_per_step=_top_kernels(prof, 3),
               losses=[f"{v:.5f}" for v in losses])
    log("s4nd_step", **rec)

    card = copy.deepcopy(cpu).cuda().eval()
    cpu.eval()
    x = torch.randn(2, 1, S4ND_RES, S4ND_RES, generator=gen)
    with torch.no_grad():
        err = rel_l2(card(x.cuda()).cpu(), cpu(x))
    log("s4nd_card_vs_cpu", size=f"2x1x{S4ND_RES}x{S4ND_RES}",
        rel_l2=f"{err:.3e}", tol=S4ND_TOL)
    require(err <= S4ND_TOL, f"S4ND card vs CPU: relative L2 {err}")
    return rec


def replays_run_kernels(eng, jnp_model, reqs: dict, outs: dict,
                        mode: str) -> None:
    """Each kernel node of each bucket's graph runs in every replay: one
    kernel layer's log_dt at a time is shifted by 0.5 in place (the
    graph reads it by address) in the served model and in ``jnp_model``,
    and the replay is held against the 'jnp' route with the same shift
    (S4ND_TOL). A node that did not run would leave the kernel of an
    earlier replay in its buffer, and the output where it was: each shift
    must move it by ten times the tolerance. With every log_dt restored,
    a replay gives ``outs`` again, bit for bit."""
    shift = 0.5
    served = dict(eng.model.named_parameters())
    ref = dict(jnp_model.named_parameters())
    names = sorted(n for n in served if n.endswith(".log_dt"))
    require(len(names) == 2 * len(jnp_model.s4_layers),
            f"s4nd_{mode}: kernel layers {names}")
    for r, x in reqs.items():
        worst, least = 0.0, math.inf
        for n in names:
            saved = served[n].detach().clone()
            with torch.no_grad():
                served[n].add_(shift)
                ref[n].add_(shift)
                got = torch.from_numpy(eng.predict(x))
                want = jnp_model(torch.from_numpy(x).cuda()).cpu()
                served[n].copy_(saved)
                ref[n].copy_(saved)
            err = rel_l2(got, want)
            moved = rel_l2(got, torch.from_numpy(outs[r]))
            worst, least = max(worst, err), min(least, moved)
            require(err <= S4ND_TOL and moved >= 10 * S4ND_TOL,
                    f"s4nd_{mode} at {r}^2, {n} + {shift}: vs jnp {err}, "
                    f"moved {moved}")
        require(np.array_equal(eng.predict(x), outs[r]),
                f"s4nd_{mode} at {r}^2: log_dt restored, replay differs")
        log("s4nd_replay_runs_kernels", mode=mode, bucket=f"{r}^2",
            shifted=f"each of {len(names)} log_dt by {shift}",
            worst_vs_jnp_rel_l2=f"{worst:.3e}",
            least_moved_rel_l2=f"{least:.3e}", tol=S4ND_TOL)


def serve_s4nd(ckpt: str) -> dict:
    """The trained S4ND restored into S4NDModel(kernel_impl='pallas') by
    ServingEngine.from_checkpoint (diag: K4), and a dplr S4NDModel at the
    same widths from the seed (K5), each one CUDA graph per bucket
    (S4ND_BATCH x S4ND_SERVE², capture seconds, peak memory): a request a
    bucket counted by its kernel's executions in the replays (one a layer
    and axis), held against the 'jnp' route on the card and against the
    CPU (S4ND_TOL), the replay against eager, every kernel node shown to
    run in every replay (replays_run_kernels), and the median predict per
    bucket graphed and eager. Returns the executions of K4 and K5."""
    from resolution_pde_tpu_torch.deploy import ServingEngine
    from resolution_pde_tpu_torch.ops.kernels import cauchy, vandermonde

    def counters():
        return {"K4": vandermonde.launches, "K5": cauchy.launches}

    executed = {"K4": 0, "K5": 0}
    rng = np.random.default_rng(SEED + 17)
    for mode, name in (("diag", "K4"), ("dplr", "K5")):
        cfg, model = _s4nd(f"model.mode={mode}", kernel_impl="pallas")
        if mode == "diag":
            eng = ServingEngine.from_checkpoint(model, ckpt, device="cuda")
        else:
            eng = ServingEngine(model, device="cuda")
        state = {k: v.detach().cpu()
                 for k, v in eng.model.state_dict().items()}
        per_layer = 2 * cfg.model.n_layers             # a kernel an axis
        per_call = {name: per_layer, ({"K4", "K5"} - {name}).pop(): 0}
        warm_graphs(eng, [((r, r), S4ND_BATCH) for r in S4ND_SERVE],
                    counters, per_call, f"s4nd_{mode}")
        _, jnp_model = _s4nd(f"model.mode={mode}", kernel_impl="jnp")
        jnp_model.load_state_dict(state)
        jnp_model.cuda().eval()
        _, cpu_model = _s4nd(f"model.mode={mode}", kernel_impl="jnp")
        cpu_model.load_state_dict(state)
        cpu_model.eval()
        reqs = {r: rng.standard_normal((S4ND_BATCH - 3 if r == 256
                                        else S4ND_BATCH, 1, r, r)).astype(
                                            np.float32)
                for r in S4ND_SERVE}

        # the main path: every count from here comes from requests
        cauchy.launches = vandermonde.launches = 0
        outs = {}
        for r, x in reqs.items():
            outs[r], ex = graph_executions(
                lambda x=x: eng.predict(x), per_call, 1,
                f"s4nd_{mode} predict of {x.shape[0]} at {r}^2")
            executed[name] += ex[name]
        require(counters() == {"K4": 0, "K5": 0},
                f"s4nd_{mode}: serving through graphs launched "
                f"{counters()} from the host")
        for r, x in reqs.items():
            got = outs[r]
            require(got.shape == x.shape and bool(np.isfinite(got).all()),
                    f"s4nd_{mode} at {r}^2: {got.shape} or non-finite")
            with torch.no_grad():
                ref = jnp_model(torch.from_numpy(x).cuda()).cpu()
                ref_cpu = cpu_model(torch.from_numpy(x))
            e = eager(eng, lambda x=x: eng.predict(x))
            err_jnp = rel_l2(torch.from_numpy(got), ref)
            err_cpu = rel_l2(torch.from_numpy(got), ref_cpu)
            log("s4nd_serve", mode=mode, bucket=f"{S4ND_BATCH}x{r}^2",
                request=x.shape[0], vs_jnp_route_rel_l2=f"{err_jnp:.3e}",
                vs_cpu_rel_l2=f"{err_cpu:.3e}", tol=S4ND_TOL,
                graph_vs_eager_max_abs=f"{np.abs(got - e).max():.3e}")
            require(err_jnp <= S4ND_TOL and err_cpu <= S4ND_TOL,
                    f"s4nd_{mode} at {r}^2: vs jnp {err_jnp}, vs CPU "
                    f"{err_cpu}")
            require(rel_l2(torch.from_numpy(got), torch.from_numpy(e))
                    <= 1e-6, f"s4nd_{mode} at {r}^2: graph vs eager")
        replays_run_kernels(eng, jnp_model, reqs, outs, mode)
        log("s4nd_serve", mode=mode, **{f"executions_{name}": executed[name]})
        # median predict latency per bucket, graph and eager, in turns
        for r in S4ND_SERVE:
            x = rng.standard_normal((S4ND_BATCH, 1, r, r)).astype(np.float32)
            g1 = median_ms(lambda: eng.predict(x))
            e1 = eager(eng, lambda: median_ms(lambda: eng.predict(x)))
            g2 = median_ms(lambda: eng.predict(x))
            log("latency", model=f"s4nd_{mode}", bucket=f"{S4ND_BATCH}x{r}^2",
                graph_median_ms=f"{g1:.3f}/{g2:.3f}",
                eager_median_ms=f"{e1:.3f}")
        # where a graphed predict's device time goes, at the largest bucket
        _, prof = profiled(lambda: eng.predict(x))
        busy_ms, idle = _idle_share(prof)
        log("s4nd_serve", mode=mode, profiled=f"a predict at {r}^2",
            device_busy_ms=f"{busy_ms:.3f}", device_idle_share=f"{idle:.4f}",
            top_kernels_ms=_top_kernels(prof, 1))
        del eng, jnp_model
    return executed


def s4_seq_models() -> None:
    """S4BaseSeqModel and S4DualSeqModel at their default widths (d_model
    128, 4 layers), both modes, on SEQ_SHAPE: the convolutional forward on
    the card against the recurrence (s4seq_recurrent_fns /
    s4dualseq_recurrent_fns) stepped over T on the card, at JAX's rtol
    2e-3 / atol 2e-4; the card's forward and recurrence against the CPU's
    (1e-4 relative L2), the DPLR recurrence's discretization (a complex
    inverse and matrix power) on each."""
    from resolution_pde_tpu_torch.models import s4_base

    b, t, s_pts, v = SEQ_SHAPE
    gen = torch.Generator().manual_seed(SEED + 18)
    x = torch.randn(SEQ_SHAPE, generator=gen)
    grid = torch.linspace(0, 1, s_pts)[None, :, None].expand(b, s_pts, 1)

    def recur(model, xs, g):
        if isinstance(model, s4_base.S4DualSeqModel):
            init_state, step = s4_base.s4dualseq_recurrent_fns(model, model,
                                                               L_train=t)
            state, ys = init_state(b * s_pts), []
            for k in range(t):
                y, state = step(state, xs[:, k], g)
                ys.append(y)
            return torch.stack(ys, dim=1)
        init_state, step = s4_base.s4seq_recurrent_fns(
            model, model.d_model, model.n_layers, model.mode, L_train=t)
        xf = xs.movedim(1, 2).reshape(b * s_pts, t, v)
        gf = g.reshape(b * s_pts, -1)
        state, ys = init_state(b * s_pts), []
        for k in range(t):
            y, state = step(state, xf[:, k], gf)
            ys.append(y)
        return torch.stack(ys, dim=1).reshape(b, s_pts, t, -1).movedim(1, 2)

    for cls in (s4_base.S4BaseSeqModel, s4_base.S4DualSeqModel):
        for mode in ("diag", "dplr"):
            cpu = cls(d_input=v, mode=mode,
                      generator=torch.Generator().manual_seed(SEED)).eval()
            card = cls(d_input=v, mode=mode).eval()
            card.load_state_dict(cpu.state_dict())
            card.cuda()
            t0 = time.perf_counter()
            with torch.no_grad():
                conv = card(x.cuda(), grid.cuda())
                rec = recur(card, x.cuda(), grid.cuda())
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                conv_cpu, rec_cpu = cpu(x, grid), recur(cpu, x, grid)
            n_params = sum(p.numel() for p in card.parameters())
            worst = _within(rec.cpu(), conv.cpu(), SEQ_RTOL, SEQ_ATOL)
            err_conv = rel_l2(conv.cpu(), conv_cpu)
            err_rec = rel_l2(rec.cpu(), rec_cpu)
            log("s4_seq", model=cls.__name__, mode=mode,
                shape="x".join(map(str, SEQ_SHAPE)),
                params_m=f"{n_params / 1e6:.4f}",
                recurrence_vs_conv_worst=f"{worst:.3f}",
                rtol=SEQ_RTOL, atol=SEQ_ATOL,
                conv_card_vs_cpu=f"{err_conv:.3e}",
                recurrence_card_vs_cpu=f"{err_rec:.3e}", tol=S4ND_TOL,
                card_seconds=f"{seconds:.2f}")
            require(worst <= 1.0, f"{cls.__name__} {mode}: the recurrence "
                    f"departs from the convolution ({worst})")
            require(err_conv <= S4ND_TOL and err_rec <= S4ND_TOL,
                    f"{cls.__name__} {mode}: card vs CPU conv {err_conv}, "
                    f"recurrence {err_rec}")


def run_s4nd(ns_arrays: dict) -> dict:
    """Phase 17: main_2d model=s4_2d on phase 13's NS (s4nd_cli), the
    trained S4ND and a dplr one served through graphs on K4 and K5
    (serve_s4nd), S4ND's step and its forward against the CPU (s4nd_step),
    and the S4 sequence models' convolution against their recurrence
    (s4_seq_models). Returns the K4 and K5 executions of the serving."""
    from resolution_pde_tpu_torch.cli.generate_data import write_ns

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        [ns_path] = write_ns(f"{tmp}/data/ns", ns_arrays, file_format="mat")
        ns = [f"dataset.dataset_params.saved_folder={tmp}/data/ns",
              f"dataset.dataset_params.filename={os.path.basename(ns_path)}"]
        ckpt = s4nd_cli(tmp, ns)
        executed = serve_s4nd(ckpt)
    s4nd_step()
    s4_seq_models()
    log("s4nd", phase_seconds=f"{time.perf_counter() - t_phase:.2f}")
    return executed

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    # the plain versions' f32 products must be IEEE f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("device", name=name, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        plain_versions_tf32="off")
    print(smi, flush=True)

    from resolution_pde_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}")

    gen = torch.Generator().manual_seed(SEED)
    k1, k1f32 = check_fused_ff(gen)
    k1b, k1b32 = check_fused_ff_bwd(gen)
    check_planner_mirrors()
    k2, k3, k2wide = check_spectral(gen)
    adj16, adj32, adjwide = check_spectral_adjoint(gen)
    served = run_slice(gen)
    trained = run_train()["launched"]
    wide = run_wide()
    k4, k5 = check_s4_kernels(gen)
    s4_served = run_s4_slice()
    s4_trained = run_s4_train()
    check_fft_path(gen)
    cli = run_cli()
    ffno1d = run_ffno1d()
    ns_arrays = run_ns_sweep()
    burgers = run_burgers_darcy()
    run_cno(ns_arrays, ffno1d.pop("ks_arrays"))
    run_transformers(ns_arrays)
    s4nd = run_s4nd(ns_arrays)

    sm_src = "resolution_pde_tpu_torch/csrc/spectral_mix.cu"
    staged_src = "resolution_pde_tpu_torch/csrc/spectral_staged.cu"

    def w128(rec):
        return {f"w128_{k}": v for k, v in rec.items()}
    bwd_src = "resolution_pde_tpu_torch/csrc/fused_ff_bwd.cu"
    fwd_src = "resolution_pde_tpu_torch/csrc/fused_ff.cu"
    kernels = [
        dict(name="fused_ff_fwd_bf16", route="cuda", source=fwd_src,
             replaces="resolution_pde_tpu/ops/pallas/fused_ff.py:84",
             launches=served["bf16"][0] + trained["bf16"][0] + wide["fwd"]
             + cli["fwd"], **k1),
        dict(name="fused_ff_fwd_f32", route="cuda", source=fwd_src,
             replaces="resolution_pde_tpu/ops/pallas/fused_ff.py:84",
             launches=served["f32"][0] + trained["f32"][0] + ffno1d["fwd"]
             + ffno1d["served"] + burgers["fwd"],
             ffno1d_launches=ffno1d["fwd"] + ffno1d["served"],
             burgers_launches=burgers["fwd"], **k1f32),
        dict(name="fused_ff_bwd_bf16", route="cuda", source=bwd_src,
             replaces="resolution_pde_tpu/ops/pallas/fused_ff.py:178",
             launches=trained["bf16"][1] + wide["bwd"] + cli["bwd"], **k1b),
        dict(name="fused_ff_bwd_f32", route="cuda", source=bwd_src,
             replaces="resolution_pde_tpu/ops/pallas/fused_ff.py:178",
             launches=trained["f32"][1] + ffno1d["bwd"] + burgers["bwd"],
             ffno1d_launches=ffno1d["bwd"], burgers_launches=burgers["bwd"],
             **k1b32),
        dict(name="spectral_pass_bf16", route="cuda", source=staged_src,
             replaces="resolution_pde_tpu/ops/pallas/spectral_mix2.py:79",
             launches=served["bf16"][1] + trained["bf16"][2] + wide["k2"]
             + cli["k2"], **k2, **w128(k2wide)),
        dict(name="spectral_pass_f32", route="cuda", source=sm_src,
             replaces="resolution_pde_tpu/ops/pallas/spectral_mix.py:82",
             launches=served["f32"][1] + trained["f32"][2], **k3),
        dict(name="spectral_adjoint_bf16", route="cuda", source=staged_src,
             replaces="resolution_pde_tpu/ops/pallas/spectral_mix2.py:149",
             launches=trained["bf16"][3] + wide["adj"] + cli["adj"],
             **adj16, **w128(adjwide)),
        dict(name="spectral_adjoint_f32", route="cuda", source=sm_src,
             replaces="resolution_pde_tpu/ops/pallas/spectral_mix.py:158",
             launches=trained["f32"][3], **adj32),
        dict(name="s4d_vandermonde", route="cuda",
             source="resolution_pde_tpu_torch/csrc/vandermonde.cu",
             replaces="resolution_pde_tpu/ops/pallas/vandermonde.py:46",
             launches=s4_served["diag"] + s4_trained["diag"] + s4nd["K4"],
             s4nd_launches=s4nd["K4"], **k4),
        dict(name="cauchy", route="cuda",
             source="resolution_pde_tpu_torch/csrc/cauchy.cu",
             replaces="resolution_pde_tpu/ops/pallas/cauchy.py:52",
             launches=s4_served["dplr"] + s4_trained["dplr"] + s4nd["K5"],
             s4nd_launches=s4nd["K5"], **k5),
    ]
    # the serving paths' counts are executions inside CUDA graph replays
    counted = ("host launches (the wrappers' counters) on the training and "
               "command-line paths; executions inside the serving paths' "
               "CUDA graph replays, counted by torch.profiler by symbol name")
    for k in kernels:
        if k["name"] in ("fused_ff_fwd_bf16", "fused_ff_fwd_f32",
                         "spectral_pass_bf16", "spectral_pass_f32",
                         "s4d_vandermonde", "cauchy"):
            k["launches_counted_as"] = counted
    dead = [k["name"] for k in kernels if k["launches"] < 1]
    require(not dead, f"kernels never launched on the main paths: {dead}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
