"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

From the root of a checkout. Phases, each printed as one JSON line:

1. the card: ``nvidia-smi`` name and power limit, torch/CUDA versions and
   the TF32 flags the port sets;
2. the build of every kernel of the main path from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, all started together), with
   ptxas's registers and spills per kernel and the tensor-core
   instructions (HGMMA, HMMA) in each library's SASS;
3. each kernel against its plain PyTorch version on the card, fp32 and
   bf16, at the main path's shapes and at edge shapes (n = 17 and 200001,
   tie rows, all-zero rows, subnormal rows; value order past the decision
   kernel's shared-memory sort, kb 16385 to 65536): index sets and orders
   must be equal, values within the stated tolerance. The decision also on
   flat leaves, the main path's form (``DECISION_FLAT``: the FCN's leaves,
   the cluster's slice edges, ties across its CTAs, ragged slices, partly
   live rows, kb = 1 and kb = block, ``hier_100k``'s four leaves at a
   chunk of 500 clients), equal bit for bit to the padded layout's call
   and to a second call; the projection over leaf tables
   (``PROJECTION_TABLES``) equal bit for bit to the left-to-right sum of
   one-leaf calls and to a second call. The dequant-accumulate
   kernel, int8 and fp8, must equal its plain version bit for bit
   (``torch.equal``), on the card and on the CPU, at every leaf shape of
   the FCN and CNN and with phantom NaN clients, w = 0 clients, every
   client on the same positions, kb = 1, a 10-wide block, indices at
   the edges of its 4096-float segments and 8192-entry windows, and
   qwen3-1.7b's ``embed`` leaf in the top-k layout at a chunk of 2
   (``DEQUANT_LM``: (2, 4752, 654) into (4752, 65536), on the card);
4. the main path: ``run_experiment`` for ``paper-fcn`` at the paper's
   cohort (K=100, tau=2, lr=0.05, b=16, label skew with 3 classes per
   client, chunked scheduler) with the dense store, the top-k store and the
   top-k store's index-order decision, 3 rounds each, then one
   ``paper-cnn`` dense-store phase; then the compressed uplink: the top-k
   store (delta 0.9) under the stochastic int8 and the round-to-nearest
   fp8 wire codec, and the dense store under top-K 0.1 with error
   feedback (delta 0.75) and under ATOMO rank 2 (delta 0.5). The launch
   counters are set to 0 just before each phase and read just after;
   every kernel of a phase must have launched, and a dense phase must call
   the projection once per chunk (one call over every leaf), and the record
   splits the launches by call shape. The same spec then runs
   with ``device="cpu"`` (the plain versions): uplink floats, scalar
   fraction, wire bytes and savings must be identical, loss and params
   within tolerance, and no client's sin² may lie within 1e-5 of delta (a
   float-level flip would otherwise be possible);
5. one profiled round each of the dense, top-k and top-k int8 FCN
   phases: wall time, device busy time and idle share, and the kernels
   that took the most device time. Then the robust, attacked and buffered
   rounds at the same cohort (``robust_phases``): ``fcn_topk_signflip_gm``
   (top-k, delta 0.9, the geometric median against sign-flipping clients,
   dropout 0.1), ``fcn_dense_gaussian_trimmed`` (dense store, delta 0.3,
   the trimmed mean against Gaussian noise drawn on the card),
   ``fcn_topk_int8_scalar_median`` (the scalar median against a colluding
   cohort, int8 wire) and ``fcn_buffered_straggler`` (the buffered
   scheduler, a straggling head cohort, int8: the dequant fold reads the
   staleness buffer), each against its CPU run (discrete fields, the
   delivered and evicted counts and the Byzantine cohort equal; loss rtol
   1e-4, the run's update within 1e-3 relative L2) with its launches a
   round held, its ms per round, peak memory and the rule's own ms; then
   one profiled round of the first. Then one-host scale-out
   (``hier_*``, checkpoints under a temporary directory):
   ``hier_100k_topk_host`` runs ``examples/specs/hier_100k.json``
   (K=100,000 in chunks of 500, the ``topk-host`` bank in pinned host
   memory at k_frac 0.05, tiers [256, 16] shuffled, a checkpoint every 5
   rounds, prefetch on) for 10 of its 20 rounds: ms a round, round 4 profiled
   with the streamer's copies apart from the kernels, the host bank, one
   streamed chunk's device bytes, the peak, the tier bytes);
   ``hier_100k_vs_topk`` (3 rounds of the in-memory ``topk`` bank without
   tiers equal the ``topk-host`` run's bit for bit, history and params;
   the ``topk-host`` peak at K=100,000 within 5% of the in-memory bank of
   the K=10,000 run's); ``hier_100k_resume`` (the CLI's ``main`` for 2
   rounds with a checkpoint every 2, then ``--rounds 3 --resume`` in a new
   engine: records and final params bit for bit); ``hier_card_vs_cpu`` (K=2,000, chunk 100,
   tiers [16, 4], delta 0.45, 3 rounds against the CPU run). Then the
   ``(clients, model)`` mesh: ``fl_sharded_mesh_card_2x2`` and ``_1x2``,
   the paper cohort (chunk 10) on the ``"sharded"`` scheduler with the
   ``"topk-sharded"`` store (k_frac 0.1, delta 0.2, 2 rounds), 4 and 2
   ranks spawned at once on the one card with ``torchrun``'s environment
   (the engine's mesh starts the group: gloo carrying CUDA tensors); each
   world also runs the CPU rank tests' FCN at d_model 704 (recycle
   rounds; model rank 1's decision at its live fc1/w rows) and then the
   CLI, ``repro_torch.fed.run.main`` on every rank (rank 0 alone prints
   and writes ``--out``; the world ends): every rank's history and
   params equal; against the chunked run on the card from the same
   weights the exact fields equal, loss rtol 1e-5, params rtol 1e-4 /
   atol 1e-6, each client's sin² rtol 1e-5 / atol 1e-6; each rank's
   bank bytes 1/(c·m) of the bank for fc1/w (model-sharded), 1/c for the
   rest; ms a round (probed, and the CLI's without the probe), the
   all_reduce calls, bytes and ms a round, the decision's launch shapes
   at the rank slices;
6. LM serving (``lm_*`` phases), after the flash-attention and RWKV6-scan
   kernels were held against their plain versions (``lm_kernel_checks``,
   with phase 3; flash in bf16 on the tensor-core kernel, in fp32 on the
   CUDA-core kernel, at the edges of its 128-query and 64-key tiles too;
   the scan at chunk edges, hd 32, B * H = 1 and 8 * 40, decays past the
   clamp, and with the state updated in place):
   full-width qwen3-1.7b and rwkv6-3b in bf16, weights
   drawn on the card from seed 0, one model at a time. ``make_prefill_step``
   at B=4, T=4096 must launch its kernel once per layer, and every block
   must give the plain kernels' output on the same input (qwen3's
   last-position logits also end to end; the 32-layer random-init rwkv6
   is chaotic in bf16, which a nudge of its scan measures); the greedy
   driver ``generate`` (B=8, prompt 128, gen 32, cache 4096) gives ms per
   decode step, with rwkv6's scan launched once per layer per step, and
   decode is held against the forward over the prompt (rwkv6 layer by
   layer, with its carried state). The zoo's flash calls are held in
   ``lm_kernel_checks`` too (``FLASH_ZOO_CASES``, bf16 and fp32): head
   dim 256 at recurrentgemma's 10 query heads over 1 kv head (T = 1,
   100, 129, 4096, window 2048 and none, non-causal, its prefill call),
   the head maps 56/8, 64/8, 96/8, 12/2, 48/8 (window 4096) and 40/8,
   mixtral's and llama4's prefill calls, whisper's encoder and cross
   calls;
7. LM training (``lm_train_*`` phases), after
   ``lm_train_kernel_checks`` (each differentiable kernel's forward +
   backward against the plain forward under autograd on the card: flash in
   bf16 at qwen3's training call, B=2, T=2048, each gradient within 2e-2
   of its max against the fp32 plain version, and in fp32 at B=1, T=512;
   the scan in fp32 at rwkv6's, within 1e-3; the two backwards' times
   beside their bounds and SDPA's backward; the projection over one
   client's table of every leaf of each LM, rwkv6's 3.60 billion
   elements included, against its plain version). ``lm_train_topk_qwen3``
   (``make_train_step``, fsdp, the top-k store at k_frac 0.01, K=4, b=2,
   T=2048, 2 steps and a third profiled: the decision kernel on every
   leaf, the ``embed`` leaf's decision on step 2's own gradient equal to
   the plain version's), ``lm_train_qwen3_layers`` and
   ``lm_train_rwkv6_layers`` (every block forward and backward on step
   1's hidden states through the kernels and through their plain
   versions, teacher forced: rwkv6 in bf16 is chaotic end to end), then
   ``lm_train_qwen3`` and ``lm_train_rwkv6``: ``launch.train.main`` at full
   width (``--clients 4`` / ``2 --batch 2 --seq 2048 --steps 4`` / ``3
   --pool 1 --delta 0.6 --lr 0.05``, replicated, dense LBGs): per step the
   loss, scalar fraction and uplink floats, ms per step (the steps after
   the first), tokens/s, peak memory, the model-FLOPs share of the bf16
   peak and launches per kernel (flash or the scan twice per layer per
   client, forward and remat recompute; the projection once per client;
   no other kernel), the last step profiled with the backwards' device
   time; qwen3 again for 2 steps
   under the plain kernels (step 1's loss within rtol 2e-3, its aggregated
   update within 2e-2 relative L2 or twice the model's own floor, the
   plain step against itself with attention outputs moved by half a bf16
   ulp, whichever is larger; decisions equal where sin² lies farther than
   1e-2 from delta). The training launches are reported in these records,
   not in the kernels line (its training shapes count per step).
   Then LBGM federated rounds of the LMs through the FL engine
   (``fl_lm_*``), the same card-drawn seed-0 bf16 weights, full width,
   remat, markov data at seq_len 2048 with one sequence per client,
   ``iid``, tau 2, b 1, lr 0.05, delta 0.6, the chunked scheduler, 3
   rounds: ``fl_lm_qwen3_dense`` (``examples/specs/qwen3_fl_lm.json``
   through the CLI's ``main``: K=4, chunk 1, the dense store; flash 448
   and the projection 4 launches a round; 2 rounds under the plain
   kernels with the training phases' rule for round 1's loss, update and
   decisions), ``fl_lm_qwen3_topk_int8`` (K=4, chunk 2, the top-k store
   at k_frac 0.01, the stochastic int8 wire: flash, the decision and the
   dequant fold once per leaf per chunk; 2 rounds), ``fl_lm_qwen3_topk_host``
   (the same on the ``topk-host`` bank with tiers [2]: its history
   equals the in-memory run's bit for bit; round 2 profiled for the
   streamer's copies), ``fl_sharded_qwen3_topk`` (the same spec on the
   ``"sharded"`` scheduler and ``"topk-sharded"`` store, the (1, 1) mesh
   of the world of one the engine starts: history, final params and
   banks equal the chunked run's bit for bit), ``fl_sharded_auto_card``
   (the same spec cut to 2 layers on a (1, 2) mesh with
   ``model_sharding="auto"``: 2 gloo ranks spawned on the card, each
   resting half the params and running the client forward and backward
   tensor-parallel, against the same spec on the (1, 1) mesh: decisions
   equal, loss within 2e-3, the final params within twice the model's own
   floor; flash at the local 8/4 heads and the decision at each rank's
   rows, both held against their plain versions and added to the kernels
   line; ms a round, all_reduce and broadcast calls and bytes a round,
   each rank's peak), ``fl_sharded_auto_recurrent_card`` (the same spec
   and checks for rwkv6-3b at 2 layers and recurrentgemma-2b at 3, one
   rglru, rglru, swa cycle, both at T 512, the ranks running one arch
   after the other: the scan at a rank's 20 of 40 heads and flash at its
   5 query heads over the one kv head, hd 256, added to the kernels line
   with the decision at each rank's rows; its (1, 1) references run after
   ``uplink_launches`` and its ranks beside the robust, scale-out and
   mesh phases, its checks after them), ``fl_sharded_auto_moe_card`` (the
   same for mixtral-8x22b at 1 of 56 layers, K=2, chunk 1, T 512, the
   third arm of those ranks: each rank's 4 of the 8 experts, the router
   gathered and the routes replicated, flash at a rank's 24 of 48 query
   heads over 4 kv heads, window 4096, the decision at each rank's rows
   of the stacked experts; the ranks' MoE drops a routing equal; each
   client's first local step within 2e-3 of the (1, 1) run's loss, the
   round losses within twice the floor run's), ``fl_sharded_auto_vlm_card``
   (the same for qwen2-vl-2b at 2 of 28 layers, K=4, chunk 2, T 512: 256
   vision-grid and 256 text positions of M-RoPE, the fourth arm of those
   ranks: flash at a rank's 6 of 12 query heads over its one kv head, the
   decision at each rank's rows of the 151,936-token embedding and head),
   ``fl_lm_rwkv6_topk`` (K=2,
   chunk 1, 2 rounds, top-k: the scan 256 a round, the decision),
   ``fl_lm_qwen3_buffered_scalar_median`` (K=4, chunk 2, top-k 0.01,
   int8, buffered with one straggler a round late, the scalar median
   against a sign-flipping client, 3 rounds: flash 448 and the decision
   28 a round; held against 2 rounds under the plain kernels by the dense
   phase's rule), and ``fl_lm_card_vs_cpu``
   (both archs at depth 2 in fp32, K=2, T=256, 2 rounds, dense store:
   ``uplink_floats``, ``frac_scalar``, ``wire_bytes`` and ``savings``
   identical to the CPU run's, losses within rtol 1e-4). Each record
   gives ms per round (the mean of rounds 2-3), the ms of its local SGD,
   tokens/s, peak memory, launches per kernel a round against the
   expected counts, and ``frac_scalar``, ``uplink_floats`` and
   ``wire_bytes`` per round;
8. the rest of the zoo through the same ``lm_prefill``/``lm_serve``
   (``lm_prefill_*``/``lm_serve_*`` of mixtral, llama4, recurrentgemma,
   qwen2vl, whisper), full width, bf16 weights drawn on the card from
   seed 0, one model at a time; mixtral cut to 8 of 56 layers, llama4 to
   1 of 48 (``reduced`` in each record). ``make_prefill_step`` at B=4,
   T=4096 (whisper: T=448 over its 1,500 stub frames; qwen2-vl with its
   256 stub patches) must launch flash once per attention call
   (recurrentgemma 8, whisper 18), and every block (the encoder's too)
   is held against the plain kernels teacher forced: dense blocks within
   5e-2 of the update's max, MoE blocks in relative L2 within 5e-2 or
   twice the floor of a half-ulp nudge of the plain attention, with the
   routes and drops that differ; the whole prefill too except for MoE.
   ``generate`` (B=8, prompt 128, gen 32, llama4 gen 8; cache 4096,
   whisper 448 against the stub frames) runs no kernel; decode is held
   against forward at position 0, and layer by layer over the prompt
   for recurrentgemma and whisper (``enc_out`` the encoder's output),
   where the reference's decode equals its prefill. Then
   The zoo trains the same way (``TRAIN_RUNS``, ``TOPK_RUNS``), after
   its serving phases, one model at a time: ``lm_train_recurrentgemma``
   (K=2, b=1, T 2048: flash at hd 256 with window 2048, 8 a forward),
   ``lm_train_qwen2vl`` (K=4, b=1, T 2048, 256 stub patches),
   ``lm_train_whisper`` (K=4, b=2, T 448 over 1,500 stub frames: flash
   18 a forward), each with its ``_layers`` check and held against the
   plain kernels' run as qwen3 is; ``lm_train_mixtral`` (1 of 56 layers,
   fsdp, top-k 0.01, K=2, b=1, T 2048: the decision on every leaf, the
   stacked experts' 805-million-element leaves included, the ``w_gate``
   leaf's decision equal to the plain version's and timed; held against
   the plain kernels' run, its MoE blocks against the nudge floor) and
   ``fl_lm_mixtral_topk`` (the same weights through ``run_experiment``:
   K=2, tau 2, top-k 0.01, 3 rounds, the third profiled, against 2 rounds
   under the plain kernels); then ``lm_train_mixtral_fp32`` (the same
   layer in fp32, fsdp, top-k 0.01, K=2, b=1, T 128, weights drawn on the
   card: 2 steps through the kernels against 2 under the plain flash, held
   as the card-vs-CPU phases hold theirs, since mixtral's CPU step does
   not fit the host). ``lm_train_kernel_checks`` also holds the
   zoo's flash calls forward and backward (``TRAIN_FLASH_CASES``: hd 256
   with a window, 12/2 and 48/8 heads, whisper's encoder, self and cross
   attention) and the projection over the leaf table of every arch of
   ``TRAIN_RUNS``. ``lm_train_card_vs_cpu``: mixtral (fsdp, top-k 0.01,
   its config's own mode), qwen3, rwkv6, recurrentgemma, qwen2-vl and
   whisper at ``CARD_CPU_DEPTH``'s depths in fp32, 2 steps of K=2, b=1,
   T=128 (qwen3 and rwkv6 256, qwen2-vl 272) on the card and on the CPU
   (step 1's loss within rtol 1e-4 and update within 1e-3 relative L2,
   decisions equal where sin² lies farther than 1e-5 from delta). Then
   ``lm_card_vs_cpu``: every served LM but llama4 at full width in fp32,
   T=256 (qwen3, rwkv6, qwen2-vl 2 layers, mixtral 1, recurrentgemma 3,
   whisper 2 + 2), the card's weights copied to the host, the card's
   logits against the port's CPU run (rtol 1e-3, atol 1e-4); and
   ``pca_cnn`` (``benchmarks/fig1_pca.py``'s loop through the port:
   paper CNN, 30 epochs, gradients on the card, the tracker on the host;
   each epoch's gradient within 5e-3 relative L2 of the fp64 one at the
   same params, and N95/N99 per epoch equal to those of the CPU's
   gradients at the card's params (teacher forced), or the cumulative
   share at a flip within 1e-4 of the threshold);
9. ``flash_single_bf16_p``, a finding and not a check: on the main path's
   flash call, the error that rounding p to bf16 once before P.V would
   give, beside the kernel's hi/lo split and the kernel itself;
10. the script's total seconds, then one ``kernels`` line: per kernel
   (six: the dequant-accumulate, flash
   attention and the RWKV6 scan last), its launches on the main path, its
   median time over 25 launches (CUDA events, L2 flushed before each); the
   projection and the decision at every call shape of the main path
   (``shapes``: each leaf table, each top-k leaf; flash's hd-256 prefill
   call; per training step, flash at recurrentgemma's and whisper's cross
   training calls, the projection over each training arch's leaf table
   and the decision at mixtral's expert leaf; the decision at the model
   ranks' rows of fc1/w and of qwen3's ``embed`` leaf at m = 2 and 4,
   each rank's call held against the plain version),
   each with its launches
   there, the decision with its live bound and its padded layout's,
   the device kernels one call runs (``device_kernels_per_call``, counted
   in a ``torch.profiler`` trace of that call), its plain version's time,
   one PyTorch call's time as a yardstick where there is one, and the
   least time the card could take for the same work (flash also its
   achieved TFLOP/s). The times and counts are taken right after phase 3,
   before the main path; the line is printed last.

It exits non-zero, with no result line, when there is no CUDA card, when a
kernel does not build, launch or agree, or when any phase fails. The last
line of its output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROUNDS = 3
TIMED_LAUNCHES = 25


#: the script's start (``main``), for each record's ``t_s``
T_START = None
#: the card's name and power limit as nvidia-smi prints them (``main``)
SMI_LINE = None
#: the kernels line's records of training call shapes measured in the
#: training phases: (kernel, record); their launches are per training step
TRAIN_SHAPE_RECORDS = []


def emit(record):
    if T_START is not None:
        record = dict(record, t_s=round(time.perf_counter() - T_START, 1))
    print(json.dumps(record), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sync():
    """Wait for the card where this process uses one (a CPU-only worker
    never touches CUDA)."""
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


# ---------------------------------------------------------------- timing

_flush = None


def time_ms(fn, n=TIMED_LAUNCHES, flush=True):
    """Median device time of ``fn`` over ``n`` calls, CUDA events around
    each, with a 1 GiB write before each call. The write flushes the 50 MB
    L2 and keeps the device busy for ~0.3 ms, long enough for the host to
    enqueue the call (a wrapper's Python and ctypes overhead) before the
    device reaches it, so the events time the device's work. With
    ``flush=False`` a small wait kernel takes the write's place, so the
    call finds its inputs in L2, as on the main path where a producer has
    just written them."""
    import torch
    global _flush
    if _flush is None:
        _flush = torch.empty(2 ** 28, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        if flush:
            _flush.zero_()
        else:
            torch.cuda._sleep(1_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return median(times)


def bound_ms(bytes_moved, flops, bf16=False):
    """The least time of the work on one H100 SXM: the larger of the
    bytes over HBM's rate and the operations over the fp32 CUDA-core peak
    (``bf16``: the bf16 tensor-core peak); the card's peaks are
    ``repro_torch.analysis.roofline``'s."""
    from repro_torch.analysis import roofline as rl
    t_bytes = bytes_moved / rl.HBM_BW * 1e3
    t_ops = flops / (rl.PEAK_FLOPS if bf16 else rl.FP32_PEAK_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_label(mangled):
    """``name<types,ints>`` of a kernel's mangled name (``_Z...``), also
    one nested in a namespace (``_ZN...E``)."""
    import re
    rest, name = mangled[2:], "?"
    nested = rest.startswith("N")
    rest = rest[1:] if nested else rest
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group()
        name, rest = rest[len(n):len(n) + int(n)], rest[len(n) + int(n):]
        if not nested:
            break
    types = {"I13__nv_bfloat16": "bf16", "If": "f32", "Ia": "int8",
             "I13__nv_fp8_e4m3": "e4m3"}
    args = [v for k, v in types.items() if rest.startswith(k)]
    args += re.findall(r"Li(\d+)E", rest)
    return f"{name}<{','.join(args)}>"


def ptxas_usage(logs):
    """``{library: {kernel<types,ints>: {"registers", "spill_bytes",
    "static_smem_bytes"}}}`` from nvcc's ``-Xptxas -v`` output (dynamic
    shared memory, which the launches request, is not ptxas's to see)."""
    import re
    out = {}
    for lib, log in logs.items():
        cur, kernels = None, {}
        for line in log.splitlines():
            m = re.search(r"entry function '(_Z\w+)'", line)
            if m:
                cur = kernel_label(m.group(1))
                kernels[cur] = {}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and cur:
                kernels[cur]["spill_bytes"] = int(m.group(1)) + \
                    int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                kernels[cur]["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                kernels[cur]["static_smem_bytes"] = int(m.group(1)) if m \
                    else 0
        out[lib] = kernels
    return out


def tensor_core_instructions(libs):
    """``{library: {"HGMMA": n, "HMMA": n}}``: tensor-core instructions in
    each library's SASS (``cuobjdump -sass``), evidence of which kernels
    use the tensor cores; None where the toolkit has no cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = {}
    for lib, path in libs.items():
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                              text=True, timeout=300).stdout
        out[lib] = {op: sum(1 for line in sass.splitlines()
                            if f" {op}." in line or f" {op} " in line)
                    for op in ("HGMMA", "HMMA")}
    return out


# ----------------------------------------------------------- kernel checks

def rand_inputs(gen, shape, dtype, device, kind="normal"):
    import torch
    x = torch.randn(shape, generator=gen, dtype=torch.float32)
    if kind == "ties":      # few distinct magnitudes, both signs
        x = torch.round(x * 2) / 2
    elif kind == "zeros":
        x = torch.zeros(shape)
    elif kind == "subnormal":
        x = x * 1e-41
    elif kind == "sparse":  # fewer nonzeros than kb in each row
        x = torch.where(torch.rand(shape, generator=gen) < 0.001, x, 0.0)
    return x.to(dtype).to(device)


def check_projection(gen, B, n, dtype):
    import torch
    from repro_torch.kernels import lbgm_projection as kp
    from repro_torch.kernels import ref
    g = rand_inputs(gen, (B, n), dtype, "cuda") * 0.1
    l = rand_inputs(gen, (B, n), dtype, "cuda") * 0.1
    got = kp.lbgm_projection_batched(g, l)
    want = ref.lbgm_projection_ref(g, l)
    # the sums of |terms| bound the error of a reordered fp32 sum; bf16
    # inputs widen exactly to fp32, so one tolerance serves both types
    scale = ref.lbgm_projection_ref(g.abs(), l.abs())
    torch.cuda.synchronize()
    err = 0.0
    for a, w, s in zip(got, want, scale):
        if a.shape != (B,) or not torch.isfinite(a).all():
            fail(f"projection output {tuple(a.shape)} not finite (B={B})")
        d = (a - w).abs()
        err = max(err, float(d.max()))
        if bool((d > 1e-5 * s + 1e-30).any()):
            fail(f"projection B={B} n={n} {dtype}: error {float(d.max())}"
                 f" beyond 1e-5 of the sum of |terms|")
    return err


def check_decision(gen, B, nb, block, kb, dtype, two_pass, kind="normal"):
    import torch
    from repro_torch.kernels import lbgm_sparse as ks
    from repro_torch.kernels import ref
    blocks = rand_inputs(gen, (B, nb, block), dtype, "cuda", kind)
    idx = torch.argsort(torch.rand((B, nb, block), generator=gen),
                        dim=-1)[..., :kb].to(torch.int32).cuda()
    gg, gath, ti, tv = ks.lbgm_sparse_decision_batched(blocks, idx,
                                                       two_pass=two_pass)
    fn = (ref.lbgm_sparse_decision_two_pass_ref if two_pass
          else ref.lbgm_sparse_decision_ref)
    rgg, rgath, rti, rtv = fn(blocks, idx)
    torch.cuda.synchronize()
    what = (f"decision B={B} nb={nb} block={block} kb={kb} {dtype} "
            f"{kind} two_pass={two_pass}")
    if not torch.equal(ti, rti):
        bad = int((ti != rti).sum())
        fail(f"{what}: {bad} top-k indices differ from the plain version")
    if not torch.equal(tv, rtv) or not torch.equal(gath, rgath):
        fail(f"{what}: selected or gathered values differ")
    # the selected and gathered values are equal; only ||g||^2, a sum
    # taken in another order, differs
    err = float((gg - rgg).abs().max())
    if not torch.allclose(gg, rgg, rtol=1e-5, atol=0.0):
        fail(f"{what}: ||g||^2 off by {err:.3g}")
    return err


def flat_leaf(gen, B, size, block, kind):
    """A flat (B, size) fp32 leaf of ``kind`` on the CPU: "normal", "ties",
    "sparse" (fewer nonzeros than kb), "dense_zeros" (6% zeros), "zero_row"
    (client 0's first row zero), "slice_edges" (the largest values on both sides of each 8192-
    element slice edge of the first row), "straddle" (one magnitude spread
    over every slice, ties across CTAs)."""
    import torch
    if kind in ("normal", "ties", "sparse"):
        return rand_inputs(gen, (B, size), torch.float32, "cpu", kind)
    x = torch.randn((B, size), generator=gen)
    if kind == "zero_row":
        x[0, :block] = 0.0
    elif kind == "slice_edges":
        for e in range(8192, min(block, size), 8192):
            x[:, e - 1:e + 1] = 50.0 + e / block
    elif kind == "dense_zeros":
        x = torch.where(torch.rand((B, size), generator=gen) < 0.06, 0.0, x)
    elif kind == "straddle":
        x = torch.where(torch.rand((B, size), generator=gen) < 0.03, 1.0, 0.0)
        x[:, ::4096] = -1.0
    return x


def check_decision_flat(gen, B, size, block, kb, kind, dtype, two_pass):
    """The decision on a flat leaf (the main path's form) against its plain
    version on the same flat leaf: index sets and orders, selected and
    gathered values exactly, ||g||^2 to rtol 1e-5; against the same call
    on the zero-padded layout and against a second call (the per-client
    tickets reset) bit for bit."""
    import torch
    from repro_torch.kernels import lbgm_sparse as ks
    from repro_torch.kernels import ref
    nb = -(-size // block)
    nb = -(-nb // 16) * 16 if nb > 1 else nb
    g = flat_leaf(gen, B, size, block, kind).to(dtype).cuda()
    idx = torch.argsort(torch.rand((B, nb, block), generator=gen),
                        dim=-1)[..., :kb].to(torch.int32).cuda()
    got = ks.lbgm_sparse_decision_batched(g, idx, two_pass, block=block)
    fn = (ref.lbgm_sparse_decision_two_pass_ref if two_pass
          else ref.lbgm_sparse_decision_ref)
    want = fn(g, idx, block=block)
    padded = ks.lbgm_sparse_decision_batched(
        ref.flat_to_blocks(g, nb, block).contiguous(), idx, two_pass)
    again = ks.lbgm_sparse_decision_batched(g, idx, two_pass, block=block)
    torch.cuda.synchronize()
    what = (f"flat decision B={B} size={size} block={block} kb={kb} "
            f"{dtype} {kind} two_pass={two_pass}")
    if not torch.equal(got[2], want[2]):
        fail(f"{what}: {int((got[2] != want[2]).sum())} top-k indices "
             f"differ from the plain version")
    if not torch.equal(got[3], want[3]) or not torch.equal(got[1], want[1]):
        fail(f"{what}: selected or gathered values differ")
    err = float((got[0] - want[0]).abs().max())
    if not torch.allclose(got[0], want[0], rtol=1e-5, atol=0.0):
        fail(f"{what}: ||g||^2 off by {err:.3g}")
    for a, b, c in zip(got, padded, again):
        if not (torch.equal(a, b) and torch.equal(a, c)):
            fail(f"{what}: differs from the padded layout's call or from "
                 f"a second call")
    return err


def check_projection_table(gen, B, ns, dtype, misaligned=False):
    """One call over a table of leaves (B, n_i) against the left-to-right
    sum of one-leaf calls and a second call, bit for bit, and against the
    plain version within 1e-5 of the sum of |terms|. ``misaligned`` leaves
    start one element past an allocation (no 16-byte loads)."""
    import torch
    from repro_torch.kernels import lbgm_projection as kp
    from repro_torch.kernels import ref

    def leaves():
        out = []
        for n in ns:
            x = rand_inputs(gen, (B * n + int(misaligned),), dtype,
                            "cuda") * 0.1
            out.append(x[int(misaligned):].view(B, n))
        return out
    gs, ls = leaves(), leaves()
    got = kp.lbgm_projection_leaves(gs, ls)
    again = kp.lbgm_projection_leaves(gs, ls)
    per_leaf = None
    for g, l in zip(gs, ls):
        part = kp.lbgm_projection_batched(g, l)
        per_leaf = part if per_leaf is None else tuple(
            a + b for a, b in zip(per_leaf, part))
    want = sum_leaves(ref.lbgm_projection_ref, gs, ls)
    scale = sum_leaves(ref.lbgm_projection_ref, [g.abs() for g in gs],
                       [l.abs() for l in ls])
    torch.cuda.synchronize()
    what = f"projection table B={B} n={list(ns)[:6]} {dtype}"
    err = 0.0
    for a, p, c, w, s in zip(got, per_leaf, again, want, scale):
        if not (torch.equal(a, p) and torch.equal(a, c)):
            fail(f"{what}: differs from the per-leaf calls or a second "
                 f"call")
        d = (a - w).abs()
        err = max(err, float(d.max()))
        if bool((d > 1e-5 * s + 1e-30).any()):
            fail(f"{what}: error {float(d.max())} beyond 1e-5 of the sum "
                 f"of |terms|")
    return err


def sum_leaves(fn, gs, ls):
    """``fn``'s (gl, gg, ll) per leaf, added over the leaves in order."""
    out = None
    for g, l in zip(gs, ls):
        part = fn(g, l)
        out = part if out is None else tuple(a + b for a, b in zip(out,
                                                                   part))
    return out


def dequant_inputs(gen, C, nb, block, kb, qdtype, kind="normal"):
    """CPU inputs of one dequant-accumulate call. ``kind``: "phantom"
    gives client 1 w = 0, a NaN gscale and (fp8) NaN values; "zero_w"
    gives every other client w = 0; "shared" puts every client on the
    same positions; "edges" puts positions SEG - 1, SEG, block - 1 and 0
    (those inside the row) first in every client's indices, SEG being the
    kernel's segment of a row."""
    import torch
    from repro_torch.kernels.lbgm_sparse import DEQUANT_SEG
    acc = torch.randn((nb, block), generator=gen)
    w = torch.rand(C, generator=gen) / C
    gscale = torch.rand(C, generator=gen) * 2 - 0.5
    keys = torch.rand((1 if kind == "shared" else C, nb, block),
                      generator=gen)
    if kind == "edges":
        for pos in (DEQUANT_SEG - 1, DEQUANT_SEG, block - 1, 0):
            if pos < block:
                keys[..., pos] = -1.0
    idx = torch.argsort(keys, dim=-1)[..., :kb].to(torch.int32)
    idx = idx.expand(C, nb, kb).contiguous()
    if qdtype == torch.int8:
        qv = torch.randint(-127, 128, (C, nb, kb), generator=gen,
                           dtype=torch.int8)
    else:
        qv = (torch.randn((C, nb, kb), generator=gen) * 100).clamp(
            -448, 448).to(qdtype)
    scale = torch.ldexp(torch.ones(C, nb, 1), torch.randint(
        -20, 2, (C, nb, 1), generator=gen))
    if kind == "phantom" and C > 1:
        w[1], gscale[1] = 0.0, float("nan")
        if qdtype != torch.int8:
            qv[1] = torch.full((nb, kb), float("nan")).to(qdtype)
    elif kind == "zero_w":
        w[::2] = 0.0
    return acc, w, gscale, idx, qv, scale


def check_dequant(gen, C, nb, block, kb, qdtype, kind="normal"):
    import torch
    from repro_torch.kernels import lbgm_sparse as ks
    from repro_torch.kernels import ref
    cpu = dequant_inputs(gen, C, nb, block, kb, qdtype, kind)
    dev = [t.cuda() for t in cpu]
    got = ks.lbgm_dequant_accum(dev[0].clone(), *dev[1:])
    plain_card = ref.lbgm_dequant_accum_ref(dev[0].clone(), *dev[1:])
    plain_cpu = ref.lbgm_dequant_accum_ref(cpu[0].clone(), *cpu[1:])
    torch.cuda.synchronize()
    what = f"dequant C={C} nb={nb} block={block} kb={kb} {qdtype} {kind}"
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite accumulator (a phantom client leaked)")
    if not torch.equal(got, plain_card) or \
            not torch.equal(got.cpu(), plain_cpu):
        bad = float((got.cpu() - plain_cpu).abs().max())
        fail(f"{what}: differs from the plain version (max {bad:.3g})")
    return float((got.cpu() - plain_cpu).abs().max())


#: (C, nb, block, kb) of every top-k leaf at a chunk of 10: FCN fc1/w,
#: fc2/w, fc1/b, fc2/b; CNN conv3/w and fc/w
DEQUANT_SHAPES = [(10, 16, 65536, 627), (10, 1, 1280, 128),
                  (10, 1, 128, 12), (10, 1, 10, 1), (10, 1, 36864, 3686),
                  (10, 1, 31360, 3136)]
#: (C, nb, live rows, block, kb) of qwen3-1.7b's ``embed`` leaf (151936 x
#: 2048) in the top-k layout at k_frac 0.01, at a chunk of 2 clients: the
#: fold of ``fl_lm_qwen3_topk_int8``'s largest leaf
DEQUANT_LM = (2, 4752, 4748, 65536, 654)


def check_dequant_lm(qdtype):
    """The dequant fold at ``DEQUANT_LM``, inputs drawn on the card (the
    CPU argsort of 623 million keys would take minutes): the live rows'
    indices a random kb-subset of each row, the pad rows' iota with zero
    values, as the top-k store lays them out; bit for bit against the
    plain version on the card (the CPU's equality with it is held at the
    smaller shapes)."""
    import torch
    from repro_torch.kernels import lbgm_sparse as ks
    from repro_torch.kernels import ref
    C, nb, live, block, kb = DEQUANT_LM
    gen = torch.Generator(device="cuda").manual_seed(6)
    acc = torch.randn((nb, block), generator=gen, device="cuda")
    w = torch.rand(C, generator=gen, device="cuda") / C
    gscale = torch.rand(C, generator=gen, device="cuda") * 2 - 0.5
    idx = torch.empty((C, nb, kb), dtype=torch.int32, device="cuda")
    for c in range(C):
        keys = torch.rand((live, block), generator=gen, device="cuda")
        idx[c, :live] = torch.topk(keys, kb, dim=-1).indices.to(torch.int32)
        del keys
    idx[:, live:] = torch.arange(kb, dtype=torch.int32, device="cuda")
    if qdtype == torch.int8:
        qv = torch.randint(-127, 128, (C, nb, kb), generator=gen,
                           dtype=torch.int8, device="cuda")
    else:
        qv = (torch.randn((C, nb, kb), generator=gen, device="cuda")
              * 100).clamp(-448, 448).to(qdtype)
    qv[:, live:] = 0
    scale = torch.ldexp(torch.ones(C, nb, 1, device="cuda"), torch.randint(
        -20, 2, (C, nb, 1), generator=gen, device="cuda"))
    got = ks.lbgm_dequant_accum(acc.clone(), w, gscale, idx, qv, scale)
    want = ref.lbgm_dequant_accum_ref(acc.clone(), w, gscale, idx, qv, scale)
    torch.cuda.synchronize()
    what = f"dequant at qwen3's embed layout {DEQUANT_LM} {qdtype}"
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite accumulator")
    if not torch.equal(got, want):
        fail(f"{what}: differs from the plain version (max "
             f"{float((got - want).abs().max()):.3g})")
    return float((got - want).abs().max())


#: (C, nb, block, kb, kind) at the edges of the kernel's segments (SEG =
#: 4096 floats of a row per CTA) and windows (8192 entries of a row's
#: payload): indices at SEG - 1, SEG and block - 1; block == SEG and SEG +
#: 1; one-row leaves with block < SEG; every client on one position; a
#: client of more than a window; more clients than a window holds
DEQUANT_EDGES = [(10, 2, 8193, 5, "edges"), (10, 1, 4096, 3, "edges"),
                 (10, 3, 4097, 4, "edges"), (10, 1, 100, 7, "edges"),
                 (10, 1, 10, 1, "shared"), (10, 3, 9000, 1, "shared"),
                 (3, 2, 200000, 20000, "edges"), (300, 2, 5000, 3, "edges"),
                 (2, 3, 4097, 4097, "shared")]


#: (B, nb, block, kb, kind): value-order decisions past the kernel's
#: shared-memory sort (kb > 16384)
DECISION_PAST_SHARED_SORT = [(2, 2, 65536, 16385, "normal"),
                             (2, 2, 65536, 32768, "ties"),
                             (1, 3, 65536, 65536, "normal"),
                             (2, 2, 65536, 20000, "zeros"),
                             (2, 2, 40000, 30000, "sparse"),
                             (10, 16, 65536, 32768, "normal")]


#: (B, size, block, kb, kind): the decision on flat leaves — the FCN's
#: four leaves at a chunk of 10 (a cluster of 8, then clusters of 1), a
#: size that is not a multiple of 4 (ragged slices), the cluster's slice
#: edges, ties across CTAs, partly live rows with fewer nonzeros than kb,
#: kb = 1 and kb = block, an all-zero live row (CNN conv3/w: 5 CTAs), a
#: cluster of 2 one element past a slice, and a threshold of 0 whose zeros
#: (100 of them past `size`) rank 0 gathers; and hier_100k's four leaves
#: at its chunk of 500 clients (k_frac 0.05)
DECISION_FLAT = [(10, 100352, 65536, 627, "normal"),
                 (500, 25088, 25088, 1254, "normal"),
                 (500, 320, 320, 16, "normal"), (500, 32, 32, 1, "normal"),
                 (500, 10, 10, 1, "normal"),
                 (10, 1280, 1280, 128, "normal"), (10, 128, 128, 12, "normal"),
                 (10, 10, 10, 1, "normal"), (3, 100353, 65536, 627, "normal"),
                 (2, 70001, 65536, 2000, "ties"),
                 (2, 131072, 65536, 900, "slice_edges"),
                 (2, 131072, 65536, 700, "straddle"),
                 (2, 65636, 65536, 300, "sparse"),
                 (2, 65541, 65536, 40, "normal"),
                 (2, 131072, 65536, 1, "normal"),
                 (2, 65536, 65536, 65536, "ties"),
                 (2, 36864, 36864, 3686, "zero_row"),
                 (1, 8193, 8193, 77, "straddle"),
                 (1, 130972, 65536, 62000, "dense_zeros")]
#: (B, leaf lengths, misaligned): projection leaf tables — the FCN's and
#: the CNN's leaves in sorted key order, leaves without 16-byte loads,
#: more leaves than one launch's table (70 > 64), the unbatched form
#: value order with each placement of the kept keys forced (B, nb, block,
#: kb, kind): the main path's largest call, the CNN's conv3/w, ties, and
#: the largest kb of the shared-memory sort
PLACEMENT_CHECKS = [(10, 16, 65536, 627, "normal"), (4, 1, 36864, 3686,
                                                      "normal"),
                    (2, 2, 65536, 627, "ties"), (2, 1, 9216, 921, "ties"),
                    (2, 2, 65536, 16384, "ties")]

PROJECTION_TABLES = [
    (10, (128, 100352, 10, 1280), False),
    (10, (800, 32, 18432, 64, 36864, 64, 31360, 10, 1, 4096), False),
    (3, (17, 4097, 100352, 5), True), (2, tuple(range(1, 140, 2)), False),
    (1, (100352,), False)]


def kernel_checks():
    import torch
    gen = torch.Generator().manual_seed(0)
    errs = {"lbgm_projection": 0.0, "lbgm_sparse_decision": 0.0,
            "lbgm_sparse_decision_two_pass": 0.0, "lbgm_dequant_accum": 0.0}
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        # main-path shapes: FCN leaves at a chunk of 10, CNN conv3/w, fc/w
        # and the unbatched (B = 1) form; then odd lengths
        for B, n in ((10, 100352), (10, 1280), (10, 128), (10, 10),
                     (10, 36864), (10, 31360), (1, 100352), (1, 17),
                     (3, 200001), (2, 65536), (4, 1000), (1, 1)):
            errs["lbgm_projection"] = max(errs["lbgm_projection"],
                                          check_projection(gen, B, n, dtype))
            cases += 1
    shapes = [(10, 16, 65536, 627), (10, 1, 1280, 128), (10, 1, 128, 12),
              (10, 1, 10, 1), (4, 1, 36864, 3686), (4, 1, 31360, 3136),
              (1, 16, 65536, 627), (3, 2, 256, 256), (2, 3, 1000, 9)]
    for two_pass in (False, True):
        name = ("lbgm_sparse_decision_two_pass" if two_pass
                else "lbgm_sparse_decision")
        for dtype in (torch.float32, torch.bfloat16):
            for shp in shapes:
                errs[name] = max(errs[name], check_decision(
                    gen, *shp, dtype, two_pass))
                cases += 1
            for kind in ("ties", "zeros", "subnormal", "sparse"):
                for shp in ((3, 4, 4096, 64), (2, 2, 65536, 627)):
                    errs[name] = max(errs[name], check_decision(
                        gen, *shp, dtype, two_pass, kind))
                    cases += 1
    # value order past the kernel's shared-memory sort of 16384 keys: the
    # keys sorted in global scratch (tiles, then merge passes); ties,
    # all-zero rows, rows with fewer nonzeros than kb, the whole row
    for dtype in (torch.float32, torch.bfloat16):
        for *shp, kind in DECISION_PAST_SHARED_SORT:
            errs["lbgm_sparse_decision"] = max(
                errs["lbgm_sparse_decision"],
                check_decision(gen, *shp, dtype, False, kind))
            cases += 1
    # value order's two placements of a row's kept keys, each forced on
    # both sides of the default's choice: ranks counted in every CTA of
    # the cluster, and rank 0's bitonic sort
    from repro_torch.kernels import lbgm_sparse as ks
    for how in ("rank", "sort"):
        ks.set_placement(how)
        try:
            for *shp, kind in PLACEMENT_CHECKS:
                errs["lbgm_sparse_decision"] = max(
                    errs["lbgm_sparse_decision"],
                    check_decision(gen, *shp, torch.float32, False, kind))
                cases += 1
        finally:
            ks.set_placement("rule")
    # the main path's form: flat leaves on clusters, and leaf tables
    for two_pass in (False, True):
        name = ("lbgm_sparse_decision_two_pass" if two_pass
                else "lbgm_sparse_decision")
        for dtype in (torch.float32, torch.bfloat16):
            for case in DECISION_FLAT:
                errs[name] = max(errs[name], check_decision_flat(
                    gen, *case, dtype, two_pass))
                cases += 1
    for dtype in (torch.float32, torch.bfloat16):
        for B, ns, mis in PROJECTION_TABLES:
            errs["lbgm_projection"] = max(
                errs["lbgm_projection"],
                check_projection_table(gen, B, ns, dtype, mis))
            cases += 1
    for qdtype in (torch.int8, torch.float8_e4m3fn):
        for shp in DEQUANT_SHAPES:
            errs["lbgm_dequant_accum"] = max(errs["lbgm_dequant_accum"],
                                             check_dequant(gen, *shp, qdtype))
            cases += 1
        for kind in ("phantom", "zero_w", "shared"):
            for shp in ((10, 16, 65536, 627), (4, 3, 10, 1), (5, 2, 10, 10),
                        (1, 4, 1000, 37)):
                errs["lbgm_dequant_accum"] = max(
                    errs["lbgm_dequant_accum"],
                    check_dequant(gen, *shp, qdtype, kind))
                cases += 1
        for *shp, kind in DEQUANT_EDGES:
            errs["lbgm_dequant_accum"] = max(
                errs["lbgm_dequant_accum"],
                check_dequant(gen, *shp, qdtype, kind))
            cases += 1
        errs["lbgm_dequant_accum"] = max(errs["lbgm_dequant_accum"],
                                         check_dequant_lm(qdtype))
        cases += 1
    emit({"phase": "kernel_checks", "cases": cases,
          "max_abs_err": errs,
          "note": "decision: selected and gathered values equal the plain "
                  "version exactly; its error is ||g||^2's (rtol 1e-5). "
                  "dequant: equal to the plain version bit for bit",
          "value_order_shared_sort_kb": ks.shared_sort_kb(),
          "decision_flat": [list(c) for c in DECISION_FLAT],
          "projection_tables": [[B, list(ns), mis] for B, ns, mis in
                                PROJECTION_TABLES],
          "value_order_past_shared_sort": [
              list(c) for c in DECISION_PAST_SHARED_SORT],
          "value_order_placements_forced": [list(c) for c in
                                            PLACEMENT_CHECKS]})
    return errs


# ------------------------------------------------------- LM kernel checks

#: flash kernel vs plain version in fp32, rtol = atol: the JAX package's
#: own kernel-test tolerance (tests/test_kernels.py)
FLASH_TOL_FP32 = 2e-4
#: in bf16 the kernel is held against the fp32 plain version of the same
#: bf16 inputs, element by element: within one bf16 ulp of the output
#: (rtol 2^-7; rounding to bf16 alone costs up to half of one) plus an
#: absolute 1e-5 for fp32 reassociation where an output is near zero. An
#: absolute bf16 bound such as the JAX test's 2e-2 would be as large as
#: the outputs at T = 4096 (about sqrt(e / T) = 0.026)
FLASH_RTOL_BF16, FLASH_ATOL_BF16 = 2.0 ** -7, 1e-5
#: the scan kernel against its plain chunked version: the same fp32
#: arithmetic in another order of dot products (the running log decay in
#: the same order); against the per-step recurrence the JAX kernel test's
#: 1e-3, with a decay that never reaches the clamp
SCAN_TOL_CHUNKED = 1e-4
SCAN_TOL_STEPWISE = 1e-3


def check_flash(gen, B, Tq, Tk, Hq, Hkv, hd, dtype, causal, window,
                q_offset=0):
    import torch
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (torch.randn(shape, generator=gen).to(dtype).cuda()
               for shape in ((B, Tq, Hq, hd), (B, Tk, Hkv, hd),
                             (B, Tk, Hkv, hd)))
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    # the plain version in fp32 on the same (bf16-valued) inputs
    want = plain_flash(q.float(), k.float(), v.float(), causal=causal,
                       window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    what = (f"flash B={B} Tq={Tq} Tk={Tk} Hq={Hq} Hkv={Hkv} hd={hd} {dtype} "
            f"causal={causal} window={window} q_offset={q_offset}")
    if got.shape != want.shape or got.dtype != dtype or \
            not torch.isfinite(got).all():
        fail(f"{what}: output {tuple(got.shape)} {got.dtype} not finite")
    rtol, atol = ((FLASH_TOL_FP32, FLASH_TOL_FP32) if dtype == torch.float32
                  else (FLASH_RTOL_BF16, FLASH_ATOL_BF16))
    err = float((got.float() - want).abs().max())
    if not torch.allclose(got.float(), want, rtol=rtol, atol=atol):
        fail(f"{what}: error {err:.3g} beyond rtol {rtol:.3g}, atol {atol}")
    return err


def scan_inputs(gen, B, T, H, hd, state, decay):
    """r, k, v, logw, u, state0 on the card. ``decay``: "model" draws the
    log decay around the LM's initial -1 per step (-exp(N(0, 0.04^2))),
    which reaches the chunked form's clamp (|cum| > 60) in the last steps
    of a 64-step chunk; "strong" doubles it, past the clamp from step 30
    (-cum up to 128); "mild" is the JAX kernel test's -0.7 sigmoid(N),
    which never does. ``state``: "zeros" or "random"."""
    import torch
    r, k, v = (torch.randn((B, T, H, hd), generator=gen) * 0.5
               for _ in range(3))
    z = torch.randn((B, T, H, hd), generator=gen)
    logw = {"model": -torch.exp(0.04 * z),
            "strong": -2 * torch.exp(0.04 * z),
            "mild": -0.7 * torch.sigmoid(z)}[decay]
    u = torch.randn((H, hd), generator=gen) * 0.5
    s0 = (torch.zeros((B, H, hd, hd)) if state == "zeros"
          else torch.randn((B, H, hd, hd), generator=gen) * 0.5)
    return [t.cuda() for t in (r, k, v, logw, u, s0)]


#: (B, T, H, hd, state, decay, in_place) edge calls of the scan kernels
SCAN_EDGES = [(2, 63, 40, 64, "zeros", "mild", False),
              (2, 64, 40, 64, "random", "model", False),
              (2, 65, 40, 64, "random", "model", True),
              (2, 129, 4, 32, "random", "strong", False),
              (1, 4096, 1, 64, "random", "model", False),
              (1, 1, 1, 64, "random", "model", True),
              (8, 65, 40, 64, "random", "strong", True),
              (8, 1, 40, 64, "random", "strong", True),
              (2, 4096, 40, 32, "random", "model", False)]


def check_scan(gen, B, T, H, hd, state, decay, in_place=False):
    """The scan against its chunked plain version (and the per-step
    recurrence where that applies); ``in_place``: also the state updated in
    place (``state_out=state0``), which must equal the fresh one bit for
    bit."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rs
    r, k, v, logw, u, s0 = scan_inputs(gen, B, T, H, hd, state, decay)
    out, st = rs.rwkv6_scan(r, k, v, logw, u, s0)
    ro, rst = ref.rwkv6_chunked_ref(r, k, v, logw, u, s0, min(rs.CHUNK, T))
    torch.cuda.synchronize()
    what = f"scan B={B} T={T} H={H} hd={hd} state={state} decay={decay}"
    if not (torch.isfinite(out).all() and torch.isfinite(st).all()):
        fail(f"{what}: non-finite output or state")
    if in_place:
        cache = s0.clone()
        out2, _ = rs.rwkv6_scan(r, k, v, logw, u, cache, state_out=cache)
        torch.cuda.synchronize()
        if not (torch.equal(out2, out) and torch.equal(cache, st)):
            fail(f"{what}: the in-place state update differs from the "
                 f"fresh state")
    err = max(float((out - ro).abs().max()), float((st - rst).abs().max()))
    tol = SCAN_TOL_CHUNKED
    if not (torch.allclose(out, ro, rtol=tol, atol=tol)
            and torch.allclose(st, rst, rtol=tol, atol=tol)):
        fail(f"{what}: error {err:.3g} vs the chunked plain version beyond "
             f"rtol = atol = {tol}")
    err_step = None
    if T <= 256 and state == "zeros" and decay == "mild":
        flat = lambda a: a.permute(0, 2, 1, 3).reshape(B * H, T, hd)
        want = ref.rwkv6_scan_ref(flat(r), flat(k), flat(v), flat(logw),
                                  u.repeat(B, 1))
        want = want.reshape(B, H, T, hd).permute(0, 2, 1, 3)
        err_step = float((out - want).abs().max())
        tol = SCAN_TOL_STEPWISE
        if not torch.allclose(out, want, rtol=tol, atol=tol):
            fail(f"{what}: error {err_step:.3g} vs the per-step recurrence "
                 f"beyond rtol = atol = {tol}")
    return err, err_step


#: (group, (B, Tq, Tk, Hq, Hkv, hd, causal, window)) flash calls of the
#: zoo, each run in bf16 and fp32: head dim 256 at recurrentgemma-2b's 10
#: query heads over 1 kv head (T = 1, 100, 129, 4096, window 2048 and
#: none, non-causal 100 x 300, and its prefill call), the head maps of
#: yi-34b (56/8), deepseek-67b (64/8), mistral-large (96/8), qwen2-vl
#: (12/2), mixtral (48/8, window 4096) and llama4 (40/8), the two MoE
#: prefill calls, and whisper's encoder (1500 frames) and cross attention
#: (448 decoder rows over 1500 frames)
FLASH_ZOO_CASES = (
    [("hd256", (2, T, T, 10, 1, 256, True, w))
     for T in (1, 100, 129, 4096) for w in (2048, None)]
    + [("hd256", (2, 100, 300, 10, 1, 256, False, None)),
       ("hd256_prefill", (4, 4096, 4096, 10, 1, 256, True, 2048)),
       ("head_maps", (2, 257, 257, 56, 8, 128, True, None)),
       ("head_maps", (2, 200, 200, 64, 8, 128, True, None)),
       ("head_maps", (2, 129, 129, 96, 8, 128, True, None)),
       ("head_maps", (2, 300, 300, 12, 2, 128, True, None)),
       ("head_maps", (2, 257, 257, 48, 8, 128, True, 4096)),
       ("head_maps", (2, 257, 257, 40, 8, 128, True, None)),
       ("moe_prefill", (4, 4096, 4096, 48, 8, 128, True, 4096)),
       ("moe_prefill", (4, 4096, 4096, 40, 8, 128, True, None)),
       ("whisper", (4, 1500, 1500, 8, 8, 64, False, None)),
       ("whisper", (4, 448, 1500, 8, 8, 64, False, None))])


def lm_kernel_checks():
    """Both LM kernels against their plain versions on the card, at the
    full-width models' shapes (qwen3: Hq 16, Hkv 8, hd 128; rwkv6: H 40,
    hd 64) and at edge shapes. Returns the largest errors."""
    import torch
    gen = torch.Generator().manual_seed(3)
    errs = {"flash_attention": 0.0, "rwkv6_scan": 0.0,
            "rwkv6_scan_vs_per_step": 0.0}
    cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        flash = [(2, T, T, 16, 8, 128, dtype, True, w)
                 for T in (1, 100, 4096) for w in (None, 1000)]
        flash += [(2, 100, 100, 16, 8, 128, dtype, False, None),
                  (2, 64, 4096, 16, 8, 128, dtype, False, None),
                  (2, 100, 300, 16, 8, 128, dtype, True, None),
                  (2, 100, 300, 16, 8, 128, dtype, True, 1000),
                  (2, 300, 100, 16, 8, 128, dtype, True, None),
                  (2, 32, 64, 4, 2, 32, dtype, True, 50),
                  (2, 100, 100, 4, 4, 64, dtype, True, 50)]
        # the tiles' edges: one row into a second 128-query tile; windows
        # across 64-key tiles; hd 32 and 64 at odd lengths; one key past a
        # tile; 1,280 CTAs, so the heaviest-first grid runs many waves
        flash += [(2, 129, 129, 4, 2, 128, dtype, True, None),
                  (1, 200, 200, 8, 8, 64, dtype, True, 150),
                  (3, 257, 257, 12, 4, 128, dtype, True, 200),
                  (2, 300, 300, 4, 2, 32, dtype, True, 130),
                  (2, 260, 260, 4, 1, 64, dtype, True, None),
                  (2, 64, 65, 4, 2, 64, dtype, False, None),
                  (8, 640, 640, 32, 8, 64, dtype, True, None)]
        for case in flash:
            errs["flash_attention"] = max(errs["flash_attention"],
                                          check_flash(gen, *case))
            cases += 1
        # Tq != Tk, Tq % 128 != 0, and a q_offset: the last 130 rows of 700
        errs["flash_attention"] = max(errs["flash_attention"], check_flash(
            gen, 2, 130, 700, 16, 8, 128, dtype, True, None, q_offset=570))
        cases += 1
        # a query block continuing a cache: absolute positions 200..299
        errs["flash_attention"] = max(errs["flash_attention"], check_flash(
            gen, 2, 100, 300, 16, 8, 128, dtype, True, 150, q_offset=200))
        cases += 1
    # the call lm_prefill_qwen3 makes: B=4, T=4096, bf16, causal
    errs["flash_attention"] = max(errs["flash_attention"], check_flash(
        gen, 4, 4096, 4096, 16, 8, 128, torch.bfloat16, True, None))
    cases += 1
    # the zoo's calls: head dim 256 (recurrentgemma: Hq 10 over one kv
    # head, window 2048), the dense configs' and qwen2-vl's head maps,
    # whisper's encoder and cross attention; each case's largest error by
    # group
    flash_by_case = {}
    for dtype in (torch.bfloat16, torch.float32):
        for group, case in FLASH_ZOO_CASES:
            e = check_flash(gen, *case[:6], dtype, *case[6:])
            key = f"{group}_{str(dtype).split('.')[-1]}"
            flash_by_case[key] = max(flash_by_case.get(key, 0.0), e)
            errs["flash_attention"] = max(errs["flash_attention"], e)
            cases += 1
    # the scan's largest error against the chunked plain version by decay
    # and at T = 4096, so that a drift toward the tolerance shows where
    by_case = {}

    def scan_case(e, T, decay, label=None):
        errs["rwkv6_scan"] = max(errs["rwkv6_scan"], e)
        for key in (f"decay_{decay}", "T_4096" if T == 4096 else None,
                    label):
            if key:
                by_case[key] = max(by_case.get(key, 0.0), e)

    for T in (1, 37, 64, 100, 4096):
        for state in ("zeros", "random"):
            for decay in ("model", "mild"):
                e, es = check_scan(gen, 2, T, 40, 64, state, decay)
                scan_case(e, T, decay)
                if es is not None:
                    errs["rwkv6_scan_vs_per_step"] = max(
                        errs["rwkv6_scan_vs_per_step"], es)
                cases += 1
    for T in (37, 128):
        e, es = check_scan(gen, 2, T, 4, 32, "zeros", "mild")
        scan_case(e, T, "mild")
        errs["rwkv6_scan_vs_per_step"] = max(errs["rwkv6_scan_vs_per_step"],
                                             es)
        cases += 1
    # the redesigned kernels' edges: a chunk one row short, full, one row
    # over; a short last chunk at hd 32; B * H = 1 and 8 * 40; decays past
    # the clamp; the state updated in place at decode and prefill
    for case in SCAN_EDGES:
        e, es = check_scan(gen, *case)
        scan_case(e, case[1], case[5])
        if es is not None:
            errs["rwkv6_scan_vs_per_step"] = max(
                errs["rwkv6_scan_vs_per_step"], es)
        cases += 1
    # the calls lm_prefill_rwkv6 (B=4, T=4096, zero state) and lm_serve_rwkv6
    # (B=8, T=1, a carried state) make
    for B, T, state in ((4, 4096, "zeros"), (8, 1, "random")):
        e, _ = check_scan(gen, B, T, 40, 64, state, "model",
                          in_place=T == 1)
        scan_case(e, T, "model", f"main_path_{B}x{T}")
        cases += 1
    emit({"phase": "lm_kernel_checks", "cases": cases, "max_abs_err": errs,
          "flash_attention_max_abs_err_by_case": flash_by_case,
          "flash_zoo_cases": [[g] + list(c) for g, c in FLASH_ZOO_CASES],
          "rwkv6_scan_max_abs_err_by_case": by_case,
          "tolerances": {
              "flash_attention": f"vs flash_attention_gqa_ref in fp32 on "
                                 f"the same inputs: rtol = atol = "
                                 f"{FLASH_TOL_FP32} (fp32); rtol 2^-7 (one "
                                 f"bf16 ulp), atol {FLASH_ATOL_BF16} (bf16)",
              "rwkv6_scan": f"rtol = atol = {SCAN_TOL_CHUNKED} (output "
                            f"and final state) vs rwkv6_chunked_ref; "
                            f"{SCAN_TOL_STEPWISE} vs rwkv6_scan_ref (T <= "
                            f"256, zero state, mild decay); the in-place "
                            f"state equal to the fresh one bit for bit"},
          "scan_edges": [list(c) for c in SCAN_EDGES]})
    return errs


# -------------------------------------------------------------- main path

def fl_spec(model, **fl):
    from repro_torch.fed.experiment import ExperimentSpec
    base = dict(num_clients=100, tau=2, lr=0.05, batch_size=16, seed=0,
                delta_threshold=0.2, scheduler="chunked")
    base.update(fl)
    return ExperimentSpec.from_dict({
        "name": f"smoke-{model}", "model": {"name": model, "kw": {}},
        "data": {"name": "mixture", "kw": {"n": 20000, "n_eval": 1000,
                                           "seed": 0}},
        "partition": {"name": "label_skew",
                      "kw": {"classes_per_client": 3, "seed": 0}},
        "fl": base, "rounds": ROUNDS,
        "eval": {"every": 0, "final": True, "verbose": False}})


#: the main path's launches per kernel and call shape (the wrappers' keys),
#: summed over the FL phases
SHAPE_TOTALS = {}


def run_phase(label, spec, two_pass, want_kernels, totals):
    import numpy as np
    import torch
    from repro_torch.fed.engine import pick_chunk
    from repro_torch.fed.experiment import build_experiment, run_experiment
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import TWO_PASS_ENV

    os.environ[TWO_PASS_ENV] = "1" if two_pass else "0"
    # one set of initial weights for both devices
    eng, _ = build_experiment(spec, device="cpu")
    params = {k: v.numpy() for k, v in eng.params.items()}
    del eng
    # one warm-up round (CUDA context, cuBLAS/cuDNN handles, library
    # load) outside the counted, timed run
    run_experiment(spec, rounds=1, device="cuda", params=params)
    _build.reset_launch_counts()
    gpu = run_experiment(spec, device="cuda", params=params)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    by_shape = {k: dict(v) for k, v in _build.LAUNCH_SHAPES.items() if v}
    for k in want_kernels:
        if launches[k] <= 0:
            fail(f"{label}: kernel {k} never launched on the main path")
        totals[k] += launches[k]
    for k, shapes in by_shape.items():
        for shp, c in shapes.items():
            SHAPE_TOTALS.setdefault(k, {})
            SHAPE_TOTALS[k][shp] = SHAPE_TOTALS[k].get(shp, 0) + c
    chunks = spec.rounds * -(-spec.fl.num_clients
                             // pick_chunk(spec.fl.num_clients,
                                           spec.fl.chunk_size))
    if "lbgm_projection" in want_kernels and \
            launches["lbgm_projection"] != chunks:
        fail(f"{label}: {launches['lbgm_projection']} projection calls for "
             f"{chunks} chunks (one call per chunk)")
    cpu = run_experiment(spec, device="cpu", params=params)
    for r, (a, b) in enumerate(zip(gpu.history, cpu.history)):
        for k in ("uplink_floats", "frac_scalar", "wire_bytes", "savings"):
            if a[k] != b[k]:
                fail(f"{label} round {r + 1}: {k} {a[k]} on the card vs "
                     f"{b[k]} on the CPU")
        if not np.isfinite(a["loss"]) or \
                abs(a["loss"] - b["loss"]) > 1e-4 * abs(b["loss"]):
            fail(f"{label} round {r + 1}: loss {a['loss']} vs {b['loss']}")
    tl_gpu, tl_cpu = gpu.final_eval["test_loss"], cpu.final_eval["test_loss"]
    if not abs(tl_gpu - tl_cpu) <= 1e-3 * abs(tl_cpu):
        fail(f"{label}: held-out loss {tl_gpu} on the card vs {tl_cpu}")
    margin = min(float(np.min(np.abs(s - spec.fl.delta_threshold)))
                 for s in gpu.sin2)
    if margin < 1e-5:
        fail(f"{label}: a client's sin^2 lies {margin:.3g} from delta")
    rec = {"phase": label, "model": spec.model.name,
           "store": spec.fl.lbg_variant, "codec": spec.fl.codec,
           "codec_kw": spec.fl.codec_kw, "compressor": spec.fl.compressor,
           "compressor_kw": spec.fl.compressor_kw,
           "decision_order": "index" if two_pass else "value",
           "K": spec.fl.num_clients, "rounds": spec.rounds,
           "delta": spec.fl.delta_threshold,
           "chunk": pick_chunk(spec.fl.num_clients, spec.fl.chunk_size),
           "gpu_ms_per_round": gpu.us_per_round / 1e3,
           "cpu_ms_per_round": cpu.us_per_round / 1e3,
           "loss": [h["loss"] for h in gpu.history],
           "loss_cpu": [h["loss"] for h in cpu.history],
           "frac_scalar": [h["frac_scalar"] for h in gpu.history],
           "uplink_floats": [h["uplink_floats"] for h in gpu.history],
           "wire_bytes": [h["wire_bytes"] for h in gpu.history],
           "savings": gpu.savings, "sin2_margin": margin,
           "test_acc": gpu.final_eval.get("test_acc"),
           "launches": {k: v for k, v in launches.items() if v},
           "launches_by_shape": {k: [[list(shp), c] for shp, c in v.items()]
                                 for k, v in by_shape.items()}}
    emit(rec)
    return rec


def device_events(prof):
    """``({name: [device us, count]}, kernels, busy ms)`` of a profile,
    leaving out the spin kernel of ``torch.cuda._sleep``. Read from the
    profiler's raw events: ``prof.events()`` builds an event tree in
    Python, which takes minutes for a training step's 250,000 kernels."""
    from torch.autograd import DeviceType
    by_name, n_kernels = {}, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA or "spin_kernel" in ev.name():
            continue
        n_kernels += 1
        us = by_name.setdefault(ev.name(), [0.0, 0])
        us[0] += ev.duration_ns() / 1e3
        us[1] += 1
    return by_name, n_kernels, sum(v[0] for v in by_name.values()) / 1e3


def kernels_per_call(fn, tries=5):
    """Device kernels one call of ``fn`` runs, counted in a
    ``torch.profiler`` trace. A wrapper adds one to its launch count per
    call, however many kernels the call runs; this is that number. The
    profiler now and then records none or only some of a short window's
    kernels, so the call sits between spin kernels: a trace that lacks
    one of them is not read, and a count stands once two traces agree."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        spins = sum(ev.device_type == DeviceType.CUDA
                    and "spin_kernel" in ev.name for ev in prof.events())
        if spins != 3:
            continue
        _, n, _ = device_events(prof)
        if n in seen:
            return n
        seen.append(n)
    return "not measured"


def uplink_launches():
    """Device kernels, device time and host wall time of one chunk's
    uplink steps at the FCN's top-k payload shapes (10 clients): the fp32
    fold (``SparseTopKAggregator``, one ordered add per leaf), the
    quantized fold (``SparseCodecAggregator``, one dequant-accumulate
    launch per leaf), and the int8 (stochastic: JAX's threefry uniforms)
    and fp8 (nearest) encoders."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.comm import wire
    from repro_torch.core.lbgm import LBGMStats, _block_layout
    from repro_torch.fed.engine import (SparseCodecAggregator,
                                        SparseTopKAggregator)
    from repro_torch.fed.experiment import build_experiment
    eng, _ = build_experiment(fl_spec("fcn"), device="cuda")
    params, C = eng.params, 10
    gen = torch.Generator().manual_seed(2)
    send = {}
    for name, p in params.items():
        nb, block, kb = _block_layout(int(p.numel()), 0.1)
        idx = torch.argsort(torch.rand((C, nb, block), generator=gen),
                            dim=-1)[..., :kb].to(torch.int32)
        send[name] = {"idx": idx.cuda(),
                      "val": torch.randn((C, nb, kb), generator=gen).cuda()}
    w = torch.full((C,), 0.01, device="cuda")
    ones = torch.ones(C, device="cuda")
    stats = LBGMStats(sin2=ones, rho=ones, sent_scalar=ones < 0,
                      uplink_floats=ones, grad_sq_norm=ones)
    seed = torch.arange(C, device="cuda")
    int8, fp8 = wire.Int8Codec(), wire.Fp8Codec(stochastic=False)
    q8 = int8.encode_sparse((send, ones), send, stats, seed)[0]
    fold_t = SparseTopKAggregator(params, 0.1)
    fold_c = SparseCodecAggregator(params, 0.1)
    acc_t, acc_c = fold_t.init(params), fold_c.init(params)
    steps = {
        "fold_fp32": lambda: fold_t.accumulate(
            acc_t, w, (send, ones)),
        "fold_quantized": lambda: fold_c.accumulate(acc_c, w, q8),
        "encode_int8_stochastic": lambda: int8.encode_sparse(
            (send, ones), send, stats, seed),
        "encode_fp8_nearest": lambda: fp8.encode_sparse(
            (send, ones), send, stats, None)}
    out = {}
    for label, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the first kernel of a profiled window may go unrecorded: let
            # it be a spin kernel, which device_events leaves out
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        _, n, busy = device_events(prof)
        out[label] = {"device_kernels": n, "device_busy_ms": busy,
                      "wall_ms": wall_ms}
    emit({"phase": "uplink_launches", "clients": C, "leaves": len(params),
          "steps": out,
          "encode_int8_stochastic_device_kernels_before": {
              "device_kernels": 414,
              "of": "the counter-hash uniforms the codecs drew before "
                    "they replayed JAX's threefry (PERF.md §5)"}})
    return out


def profile_round(label, spec, device="cuda"):
    """One steady round of ``spec`` under ``torch.profiler``: wall time,
    the device's busy time (sum of kernel times; the round runs on one
    stream) and its idle share, and the kernels that took the most device
    time. A profiler that records no device time is reported as such."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.fed.experiment import build_experiment

    eng, _ = build_experiment(spec, device=device)
    src = eng.prefetcher(np.random.RandomState(spec.fl.seed + 1))
    try:
        eng.run_round(src)                       # warm-up
        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            eng.run_round(src)
            if device == "cuda":
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        src.close()
    by_name, n_kernels, busy_ms = device_events(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    rec = {"phase": f"profile_{label}", "wall_ms": wall_ms,
           "device_kernels": n_kernels,
           "device_busy_ms": busy_ms if n_kernels else "not measured",
           "device_idle_share": (1 - busy_ms / wall_ms) if n_kernels
           else "not measured",
           "top_kernels": [{"name": k[:80], "ms": v[0] / 1e3, "count": v[1]}
                           for k, v in top]}
    emit(rec)
    return rec


# ------------------------------------- robust, attacked, buffered rounds

#: card against CPU in fp32 (PERF.md §2): loss rtol, and the run's whole
#: update (final params minus initial) within this relative L2
FL_ROBUST_LOSS_RTOL = 1e-4
FL_ROBUST_UPDATE_RTOL = 1e-3


def robust_fl_run(spec, params, device, rounds):
    """``rounds`` rounds of ``spec`` on ``device`` from ``params`` (host
    arrays), through the engine and its prefetcher as ``run_experiment``
    drives them: (engine, ms per round on the host clock around the
    synchronised round, the collect rule's ms per round, timed between two
    synchronisations)."""
    import numpy as np
    import torch
    from repro_torch.fed.experiment import build_experiment
    eng, _ = build_experiment(spec, params=params, device=device)
    card = device == "cuda"
    rule_ms = []
    if card and getattr(eng.agg, "collect", False):
        reduce = eng.agg.reduce

        def timed_reduce(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = reduce(*a)
            torch.cuda.synchronize()
            rule_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        eng.agg.reduce = timed_reduce
    src = eng.prefetcher(np.random.RandomState(spec.fl.seed + 1))
    ms = []
    try:
        for _ in range(rounds):
            if card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run_round(src)
            if card:
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        src.close()
    return eng, ms, rule_ms


def robust_phase(label, spec, want, totals):
    """One robust, attacked or buffered FL phase of the FCN at the paper's
    cohort: a warm-up round, then ``spec.rounds`` rounds on the card with
    the launch counters set to 0 just before (``want``: launches a round
    of every kernel), then the same rounds on the CPU from the same
    params. Uplink floats, scalar fraction, wire bytes, savings, the
    delivered and evicted counts and the Byzantine cohort equal; losses
    within FL_ROBUST_LOSS_RTOL, the run's update within
    FL_ROBUST_UPDATE_RTOL relative L2; no client's sin² within 1e-5 of
    delta. The phase's launches go into the kernels line's totals."""
    import numpy as np
    import torch
    from repro_torch.fed.engine import pick_chunk
    from repro_torch.fed.experiment import build_experiment
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import TWO_PASS_ENV

    os.environ[TWO_PASS_ENV] = "0"
    eng, _ = build_experiment(spec, device="cpu")
    params = {k: v.numpy() for k, v in eng.params.items()}
    del eng
    robust_fl_run(spec, params, "cuda", 1)            # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold, left out of the phase's own peak
    held = torch.cuda.memory_allocated() / 1e9
    _build.reset_launch_counts()
    geng, gms, rule_ms = robust_fl_run(spec, params, "cuda", spec.rounds)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9 - held
    launches = dict(_build.LAUNCHES)
    by_shape = {k: dict(v) for k, v in _build.LAUNCH_SHAPES.items() if v}
    for k, n in launches.items():
        if n != want.get(k, 0) * spec.rounds:
            fail(f"{label}: {n} launches of {k} in {spec.rounds} rounds, "
                 f"want {want.get(k, 0)} a round")
        totals[k] += n
    for k, shapes in by_shape.items():
        for shp, c in shapes.items():
            SHAPE_TOTALS.setdefault(k, {})
            SHAPE_TOTALS[k][shp] = SHAPE_TOTALS[k].get(shp, 0) + c
    ceng, cms, _ = robust_fl_run(spec, params, "cpu", spec.rounds)
    exact = ("uplink_floats", "frac_scalar", "wire_bytes", "savings",
             "wire_savings", "total_wire_bytes")
    for r, (a, b) in enumerate(zip(geng.history, ceng.history)):
        for k in exact:
            if a[k] != b[k]:
                fail(f"{label} round {r + 1}: {k} {a[k]} on the card vs "
                     f"{b[k]} on the CPU")
        if not np.isfinite(a["loss"]) or abs(a["loss"] - b["loss"]) > \
                FL_ROBUST_LOSS_RTOL * abs(b["loss"]):
            fail(f"{label} round {r + 1}: loss {a['loss']} vs {b['loss']}")
    counts = {"n_delivered": [getattr(e, "n_delivered", None)
                              for e in (geng, ceng)],
              "n_evicted": [e.ledger.n_evicted for e in (geng, ceng)]}
    for k, (a, b) in counts.items():
        if a != b:
            fail(f"{label}: {k} {a} on the card vs {b} on the CPU")
    if not np.array_equal(geng._byz, ceng._byz):
        fail(f"{label}: the Byzantine cohorts differ")
    num = den = 0.0
    for k, p0 in params.items():
        g = geng.params[k].cpu().double()
        c = ceng.params[k].double()
        num += float(((g - c) ** 2).sum())
        den += float(((c - torch.from_numpy(p0).double()) ** 2).sum())
    update_err = (num / max(den, 1e-300)) ** 0.5
    if not update_err <= FL_ROBUST_UPDATE_RTOL:
        fail(f"{label}: the run's update off the CPU's by {update_err:.3g} "
             f"relative L2")
    delta = spec.fl.delta_threshold
    margin = min(float(np.min(np.abs(s - delta)))
                 for e in (geng, ceng) for s in e.sin2_history)
    if margin < 1e-5:
        fail(f"{label}: a client's sin^2 lies {margin:.3g} from delta")
    fl = spec.fl
    timed = gms[1:] or gms
    rec = {"phase": label, "model": spec.model.name,
           "scheduler": fl.scheduler, "store": fl.lbg_variant,
           "lbg_kw": fl.lbg_kw, "codec": fl.codec,
           "aggregator": fl.aggregator, "aggregator_kw": fl.aggregator_kw,
           "attack": fl.attack, "attack_frac": fl.attack_frac,
           "attack_kw": fl.attack_kw, "dropout_frac": fl.dropout_frac,
           "latency": fl.latency, "latency_kw": fl.latency_kw,
           "K": fl.num_clients, "rounds": spec.rounds, "delta": delta,
           "chunk": pick_chunk(fl.num_clients, fl.chunk_size),
           "byzantine": [int(i) for i in np.flatnonzero(geng._byz)],
           "ms_per_round": sum(timed) / len(timed),
           "ms_per_round_of": "the mean of the rounds after the first",
           "round_ms": gms, "cpu_round_ms": cms,
           "rule_ms_per_round": rule_ms or "not separated (streaming fold)",
           "peak_mem_gb": peak, "peak_mem_of": "the phase's own, above "
           f"the {held:.3f} GB held before it",
           "launches": {k: v for k, v in launches.items() if v},
           "expected_launches_per_round": {k: v for k, v in want.items()
                                           if v},
           "launches_by_shape": {k: [[list(shp), c] for shp, c in v.items()]
                                 for k, v in by_shape.items()},
           "loss": [h["loss"] for h in geng.history],
           "loss_cpu": [h["loss"] for h in ceng.history],
           "frac_scalar": [h["frac_scalar"] for h in geng.history],
           "uplink_floats": [h["uplink_floats"] for h in geng.history],
           "wire_bytes": [h["wire_bytes"] for h in geng.history],
           "savings": geng.history[-1]["savings"], **counts,
           "update_rel_l2_vs_cpu": update_err, "sin2_margin": margin,
           "tolerance": f"discrete fields, counts and cohort identical; "
                        f"loss rtol {FL_ROBUST_LOSS_RTOL}; the run's update "
                        f"relative L2 {FL_ROBUST_UPDATE_RTOL}"}
    emit(rec)
    return rec


def robust_phases(totals):
    """The robust, attacked, dropout and buffered FL phases (``fl_spec``:
    K=100, tau 2, lr 0.05, b 16, label skew, chunk 10, n=20000, seed 0),
    then one profiled round of the first."""
    from repro_torch.fed.engine import pick_chunk
    from repro_torch.fed.experiment import build_experiment
    base = fl_spec("fcn")
    eng, _ = build_experiment(base, device="cpu")
    leaves = len(eng.params)
    del eng
    K = base.fl.num_clients
    chunks = -(-K // pick_chunk(K, base.fl.chunk_size))
    decision = {"lbgm_sparse_decision": leaves * chunks}
    topk = {"lbg_variant": "topk", "lbg_kw": {"k_frac": 0.1}}
    gm = fl_spec("fcn", **topk, delta_threshold=0.9,
                 aggregator="geometric_median", aggregator_kw={"iters": 8},
                 attack="sign_flip", attack_frac=0.2,
                 attack_kw={"scale": 4.0}, dropout_frac=0.1)
    out = [robust_phase("fcn_topk_signflip_gm", gm, decision, totals)]
    # delta 0.3: at 0.2 a client's sin² lies 2.9e-6 from delta in round 3
    # (the dense store's 100 sin² crowd 0.11-0.35 on this data), inside
    # the margin that keeps a float-level flip out of the exact checks
    out.append(robust_phase(
        "fcn_dense_gaussian_trimmed",
        fl_spec("fcn", delta_threshold=0.3, aggregator="trimmed_mean",
                aggregator_kw={"beta": 0.1}, attack="gaussian",
                attack_frac=0.2, attack_kw={"sigma": 0.5}),
        {"lbgm_projection": chunks}, totals))
    out.append(robust_phase(
        "fcn_topk_int8_scalar_median",
        fl_spec("fcn", **topk, delta_threshold=0.9, codec="int8",
                aggregator="scalar_median", attack="colluding_sign",
                attack_frac=0.2),
        decision, totals))
    buffered = fl_spec(
        "fcn", **topk, delta_threshold=0.5, codec="int8",
        scheduler="buffered", latency="straggler",
        latency_kw={"frac": 0.2, "delay": 4, "cohort": "head",
                    "alpha": 0.5, "max_staleness": 6})
    out.append(robust_phase(
        "fcn_buffered_straggler", buffered.with_overrides({"rounds": 8}),
        dict(decision, lbgm_dequant_accum=leaves * chunks), totals))
    out.append(profile_round("fcn_topk_signflip_gm", gm))
    return out


# ------------------------------------------------------------ kernel line

def leaf_sizes(model):
    """Element counts of ``model``'s parameter leaves, in sorted key order
    (the order the FL phases visit them)."""
    from repro_torch.fed.experiment import build_experiment
    eng, _ = build_experiment(fl_spec(model), device="cpu")
    return [int(eng.params[k].numel()) for k in sorted(eng.params)]


def projection_record(gen, B, ns):
    """The projection over one leaf table (B, n_i) fp32: time, device
    kernels a call, the plain version's time (per-leaf sums added in
    order), the bound, and torch.bmm's time on the leaves concatenated."""
    import torch
    from repro_torch.kernels import lbgm_projection as kp
    from repro_torch.kernels import ref
    gs = [torch.randn((B, n), generator=gen).cuda() for n in ns]
    ls = [torch.randn((B, n), generator=gen).cuda() for n in ns]
    gl2 = torch.stack([torch.cat(gs, 1), torch.cat(ls, 1)], 1)
    n = sum(ns)
    bnd, by = bound_ms(2 * B * n * 4 + 3 * B * 4, 6 * B * n)
    return {
        "shape": [[B, m] for m in ns], "dtype": "float32",
        "ms": time_ms(lambda: kp.lbgm_projection_leaves(gs, ls)),
        "device_kernels_per_call": kernels_per_call(
            lambda: kp.lbgm_projection_leaves(gs, ls)),
        "plain_ms": time_ms(lambda: sum_leaves(ref.lbgm_projection_ref,
                                               gs, ls)),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": time_ms(lambda: torch.bmm(gl2, gl2.transpose(1, 2))),
        "library_call": "torch.bmm of the stacked [g;l] Gram matrix, the "
                        "leaves concatenated before timing"}


def decision_records(gen, B, size, k_frac=0.1, kb=None):
    """The decision at one leaf of the top-k store: the flat (B, size)
    fp32 leaf as the main path passes it, both orders. Each record: time,
    device kernels a call, the plain version's time, the live bound (the
    leaf read once, the live rows' indices read, the three outputs
    written) and the padded layout's (every row of (B, nb, block) and of
    the indices read), and torch.topk's time on the padded layout."""
    import torch
    from repro_torch.core.lbgm import _block_layout
    from repro_torch.kernels import lbgm_sparse as ks
    from repro_torch.kernels import ref
    nb, block, kb0 = _block_layout(size, k_frac)
    kb = kb or kb0
    flat = torch.randn((B, size), generator=gen).cuda()
    idx = torch.randint(0, block, (B, nb, kb), generator=gen,
                        dtype=torch.int32).cuda()
    padded = ref.flat_to_blocks(flat, nb, block).contiguous()
    # the three outputs of every row and gg written; the indices read of
    # the live rows only (a pad row's outputs do not depend on them), of
    # every row on the padded layout (the JAX kernel's contract)
    live = -(-size // block)
    outs = B * nb * kb * 3 * 4 + B * 4
    bnd, by = bound_ms(B * size * 4 + B * live * kb * 4 + outs, 2 * B * size)
    bnd_pad, _ = bound_ms(B * nb * block * 4 + B * nb * kb * 4 + outs,
                          2 * B * nb * block)
    lib = time_ms(lambda: torch.topk(padded.abs(), kb, dim=-1))
    recs = {}
    for two_pass in (False, True):
        fn = (ref.lbgm_sparse_decision_two_pass_ref if two_pass
              else ref.lbgm_sparse_decision_ref)
        call = (lambda tp: lambda: ks.lbgm_sparse_decision_batched(
            flat, idx, tp, block=block))(two_pass)
        recs[two_pass] = {
            "shape": [B, size, nb, block, kb], "dtype": "float32",
            "cluster_ctas": ks.cluster_size(block),
            "ms": time_ms(call),
            "device_kernels_per_call": kernels_per_call(call),
            "plain_ms": time_ms(lambda: fn(flat, idx, block=block)),
            "bound_ms": bnd, "bound_by": by,
            "bound_ms_padded_layout": bnd_pad,
            "library_ms": lib,
            "library_call": "torch.topk of |g| per row of the padded "
                            "layout (the selection only: no gather, no "
                            "||g||^2, no tie rule)"}
    return recs


#: the decision at a model rank's rows on a (clients, model) mesh: (leaf,
#: clients a rank decides for, the leaf's size, k_frac) — fc1/w at
#: fl_sharded_mesh_card's (2, 2) (a chunk of 10 over 2 client ranks) and
#: qwen3-1.7b's embed leaf at a chunk of 2 (fl_lm_qwen3_topk_int8's)
RANK_SLICE_LEAVES = (("fc1/w", 5, 784 * 128, 0.1),
                     ("qwen3-1.7b embed", 2, 151936 * 2048, 0.01))


def rank_slice_records():
    """The decision at each model rank's rows of ``RANK_SLICE_LEAVES`` at
    m = 2 and 4: the flat slice (B, elements of the rank's rows) with
    ``block=``, as ``core.lbgm_sharded`` passes it (a rank whose rows are
    all pad launches nothing). Every rank's call is held against the plain
    version (indices and values exact, ||g||^2 within 1e-5); the largest
    rank's call is timed with its bound, plain time and torch.topk's."""
    import torch
    from repro_torch.core.lbgm import _block_layout
    from repro_torch.core.lbgm_sharded import model_shard_rows
    from repro_torch.kernels import lbgm_sparse as ks
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = []
    for leaf, B, size, k_frac in RANK_SLICE_LEAVES:
        nb, block, kb = _block_layout(size, k_frac)
        for m in (2, 4):
            nb_l = model_shard_rows(nb, m)
            sizes = sorted({min(size, (r + 1) * nb_l * block)
                            - min(size, r * nb_l * block)
                            for r in range(m)} - {0}, reverse=True)
            for i, n in enumerate(sizes):
                g = torch.randn((B, n), generator=gen, device="cuda")
                idx = torch.randint(0, block, (B, nb_l, kb), generator=gen,
                                    device="cuda", dtype=torch.int32)
                got = ks.lbgm_sparse_decision_batched(g, idx, block=block)
                want = plain_decision_sliced(g, idx, block)
                torch.cuda.synchronize()
                what = f"rank-slice decision {leaf} m={m} {[B, n, nb_l]}"
                if not (torch.equal(got[2], want[2])
                        and torch.equal(got[3], want[3])
                        and torch.equal(got[1], want[1])):
                    fail(f"{what}: differs from the plain version")
                if not torch.allclose(got[0], want[0], rtol=1e-5, atol=0.0):
                    fail(f"{what}: ||g||^2 off the plain version")
                del got, want
                rec = {"shape": [B, n, nb_l, block, kb], "leaf": leaf,
                       "model_ranks": m, "dtype": "float32",
                       "exact_vs_plain": True}
                if i == 0:
                    live = -(-n // block)
                    bnd, by = bound_ms(B * n * 4 + B * live * kb * 4
                                       + B * nb_l * kb * 12 + B * 4,
                                       2 * B * n)
                    padded = ref.flat_to_blocks(g, nb_l, block)
                    rec.update(
                        ms=time_ms(lambda: ks.lbgm_sparse_decision_batched(
                            g, idx, block=block), n=10),
                        bound_ms=bnd, bound_by=by,
                        plain_ms=time_ms(lambda: plain_decision_sliced(
                            g, idx, block), n=3),
                        library_ms=time_ms(lambda: torch.topk(
                            padded.abs(), kb, dim=-1), n=3),
                        library_call="torch.topk of |g| per row of the "
                                     "rank's layout (the selection only)")
                    del padded
                else:
                    rec["timed"] = "no: the largest rank's call is"
                out.append(rec)
                del g, idx
                torch.cuda.empty_cache()
    return out


#: value order's placements, timed (B, size, block, kb): fc1/w's layout
#: over kb (clusters of 8), the CNN's four leaves past one CTA at k_frac 0.1
#: (clusters of 2-5), fc2/w and rows of one CTA and of two
PLACEMENT_SWEEP = ([(10, 100352, 65536, kb) for kb in
                    (627, 1254, 2048, 3072, 4096, 8192)] +
                   [(10, n, n, kb) for n, kb in
                    ((9216, 921), (18432, 1843), (31360, 3136),
                     (36864, 3686))] +
                   [(10, 1280, 1280, 128), (10, 4096, 4096, 410),
                    (10, 8192, 8192, 300), (10, 8192, 8192, 819),
                    (10, 9216, 9216, 200), (10, 16384, 16384, 400)])


def placement_record(gen):
    """Value order's two placements of a row's kept keys timed on the same
    inputs: ranks counted in every CTA of the cluster, and rank 0's bitonic
    sort. Each shape: both times, the rule's pick, and whether it picked
    the faster; the whole record is checked to give equal outputs."""
    import torch
    from repro_torch.kernels import lbgm_sparse as ks
    rows = []
    for B, size, block, kb in PLACEMENT_SWEEP:
        nb = -(-size // block)
        nb = -(-nb // 16) * 16 if nb > 1 else nb
        g = torch.randn((B, size), generator=gen).cuda()
        idx = torch.randint(0, block, (B, nb, kb), generator=gen,
                            dtype=torch.int32).cuda()
        call = (lambda g, idx, block: lambda: ks.lbgm_sparse_decision_batched(
            g, idx, False, block=block))(g, idx, block)
        ms, outs = {}, {}
        for how in ("rank", "sort"):
            ks.set_placement(how)
            try:
                outs[how] = call()
                ms[how] = time_ms(call)
            finally:
                ks.set_placement("rule")
        if not all(torch.equal(a, b) for a, b in zip(outs["rank"],
                                                     outs["sort"])):
            fail(f"value order at {(B, size, block, kb)}: the two "
                 f"placements differ")
        pick = "rank" if ks.places_by_rank(block, kb) else "sort"
        rows.append({"shape": [B, size, nb, block, kb],
                     "cluster_ctas": ks.cluster_size(block),
                     "rank_ms": ms["rank"], "sort_ms": ms["sort"],
                     "rule": pick, "rule_faster": ms[pick] == min(
                         ms.values())})
    return {"shapes": rows,
            "rule_faster_at": sum(r["rule_faster"] for r in rows),
            "of": len(rows)}


def kernel_line(errs):
    import torch
    gen = torch.Generator().manual_seed(1)
    # the timing method's own floor: one 1-element kernel, timed as the
    # kernels are (a call at the floor is launch and event latency)
    one = torch.zeros(1, device="cuda")
    emit({"phase": "timing_floor", "what": "one 1-element add_",
          "ms": time_ms(lambda: one.add_(1)),
          "ms_no_flush": time_ms(lambda: one.add_(1), flush=False)})
    out = []
    # the projection at every call of the dense store: one leaf table per
    # chunk of 10, the FCN's and the CNN's; the single fc1/w leaf and the
    # unbatched form (lbgm_projection_pallas) are one-leaf tables
    tables = [projection_record(gen, 10, leaf_sizes(m))
              for m in ("fcn", "cnn")]
    out.append({
        "name": "lbgm_projection", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lbgm_projection.cu",
        "replaces": "src/repro/kernels/lbgm_projection.py:112",
        "launches": None,
        "max_abs_err": errs["lbgm_projection"],
        **tables[0], "shapes": tables,
        "single_leaf": projection_record(gen, 10, [100352]),
        "unbatched": {"replaces": "src/repro/kernels/lbgm_projection.py:54",
                      **projection_record(gen, 1, [100352])}})
    # the decision at every leaf of the top-k store (the FCN's, k_frac 0.1,
    # a chunk of 10), both orders; the first is the largest call
    per_shape = [decision_records(gen, 10, n) for n in leaf_sizes("fcn")]
    # and hier_100k's: the FCN at d_model 32, k_frac 0.05, a chunk of 500
    per_shape += [decision_records(gen, 500, n, k_frac=0.05)
                  for n in HIER_LEAF_SIZES]
    per_shape.sort(key=lambda r: -r[False]["shape"][1])
    # value order past the shared-memory sort, not on the main path (no
    # spec reaches kb > 16384): fc1/w's layout at kb 32768, both orders
    past = decision_records(gen, 10, 100352, kb=32768)
    slices = rank_slice_records()
    for two_pass, name, line in ((False, "lbgm_sparse_decision", 69),
                                 (True, "lbgm_sparse_decision_two_pass",
                                  224)):
        recs = [r[two_pass] for r in per_shape]
        if not two_pass:
            recs += slices
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lbgm_sparse_decision.cu",
            "replaces": f"src/repro/kernels/lbgm_sparse.py:{line}",
            "launches": None, "max_abs_err": errs[name],
            **recs[0], "shapes": recs,
            "past_shared_sort": {k: v for k, v in past[two_pass].items()
                                 if "library" not in k},
            **({"placements": placement_record(gen)} if not two_pass
               else {})})
    out.append(dequant_entry(gen, errs))
    return out


def dequant_entry(gen, errs):
    """The dequant-accumulate kernel at the codec fold's largest call:
    fc1/w's int8 payloads at a chunk of 10 clients."""
    import torch
    from repro_torch.kernels import lbgm_sparse as ks
    from repro_torch.kernels import ref
    C, nb, block, kb = DEQUANT_SHAPES[0]
    args = [t.cuda() for t in dequant_inputs(gen, C, nb, block, kb,
                                             torch.int8)]
    acc, w, gscale, idx, qv, scale = args
    # bytes this call must move: idx (4 B) and value (1 B) per entry, the
    # row scales, w and gscale, and each accumulator element the payload
    # touches read and written once (8 B)
    rows = torch.arange(nb, device="cuda").reshape(1, nb, 1)
    flat = (rows * block + idx.long()).reshape(-1)
    touched = int(torch.unique(flat).numel())
    entries = C * nb * kb
    bnd, by = bound_ms(entries * 5 + C * nb * 4 + 2 * C * 4 + touched * 8,
                       2 * entries + 2 * C * nb)
    # the same with every accumulator element read and written, as the
    # kernel's segments move them
    bnd_rows, _ = bound_ms(entries * 5 + C * nb * 4 + 2 * C * 4
                           + nb * block * 8, 2 * entries + 2 * C * nb)
    coeff = torch.where(w > 0, w * gscale, 0.0).reshape(C, 1, 1) * scale
    vals = (coeff * qv.float()).reshape(-1)
    acc_lib = acc.clone().reshape(-1)
    acc_plain = acc.clone()
    return {
        "name": "lbgm_dequant_accum", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lbgm_dequant_accum.cu",
        "replaces": "src/repro/kernels/lbgm_sparse.py:324",
        "launches": None,
        "max_abs_err": errs["lbgm_dequant_accum"],
        "shape": [C, nb, block, kb], "dtype": "int8 values, float32 acc",
        "touched_elements": touched,
        "ms": time_ms(lambda: ks.lbgm_dequant_accum(acc, *args[1:])),
        "device_kernels_per_call": kernels_per_call(
            lambda: ks.lbgm_dequant_accum(acc, *args[1:])),
        "ms_inputs_in_l2": time_ms(
            lambda: ks.lbgm_dequant_accum(acc, *args[1:]), flush=False),
        "plain_ms": time_ms(lambda: ref.lbgm_dequant_accum_ref(
            acc_plain, *args[1:])),
        "bound_ms": bnd, "bound_by": by,
        "bound_ms_every_element": bnd_rows,
        "library_ms": time_ms(lambda: acc_lib.scatter_add_(0, flat, vals)),
        "library_call": "torch.Tensor.scatter_add_ of the pre-dequantized "
                        "values (adds in no fixed order; no widening, no "
                        "phantom gate)"}


# ------------------------------------------------------------ LM serving

#: bf16 model comparisons (kernel path against plain path, decode against
#: forward): max |a - b| over max |b|, at most the JAX serve test's rtol.
#: Both sides round activations to bf16 in every layer, where one ulp is
#: 2^-8 relative; the decode path also rounds the softmax weights to bf16
BF16_MODEL_TOL = 5e-2
#: card against CPU at depth 2 in fp32, TF32 off: matmul and attention
#: sums in other orders
CARD_CPU_RTOL, CARD_CPU_ATOL = 1e-3, 1e-4
LM_KERNEL = {"qwen3-1.7b": "flash_attention", "rwkv6-3b": "rwkv6_scan"}
#: the LM kernels (the plain runs launch neither)
LM_KERNELS = ("flash_attention", "rwkv6_scan")
#: prompt steps over which rwkv6's decode state and logits are held against
#: prefill: at the model's initial decay of e^-1 per step the reference's
#: chunked form reaches its exp(-cum) clamp from step 60 of a 64-step
#: chunk and is inexact there (ROADMAP §3); below it the two forms are the
#: same recurrence
RWKV6_EXACT_PREFIX = 48


def norm_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


#: bytes of fp32 scores past which ``plain_flash`` runs one batch row at a
#: time (mixtral's prefill call, B=4 x 48 heads x 4096^2, would hold 13 GB
#: of scores three times over beside 41 GB of weights)
PLAIN_FLASH_ROW_BYTES = 2 ** 32


def plain_flash(q, k, v, **kw):
    """``flash_attention_gqa_ref``, one batch row at a time where its
    (B * Hq, Tq, Tk) fp32 scores would pass ``PLAIN_FLASH_ROW_BYTES``."""
    import torch
    from repro_torch.kernels import ref
    B, Tq, Hq, _ = q.shape
    if 4 * B * Hq * Tq * k.shape[1] <= PLAIN_FLASH_ROW_BYTES:
        return ref.flash_attention_gqa_ref(q, k, v, **kw)
    return torch.cat([ref.flash_attention_gqa_ref(
        q[b:b + 1], k[b:b + 1], v[b:b + 1], **kw) for b in range(B)])


@contextlib.contextmanager
def plain_lm_kernels():
    """Route the LM's two kernel calls (``kernels.ops.flash_attention``
    and ``ops.rwkv6_scan``, looked up at call time by the models) to their
    plain versions on the card, for a comparison run only."""
    import torch
    from repro_torch.kernels import ops, ref
    saved = ops.flash_attention, ops.rwkv6_scan

    def flash(q, k, v, *, causal=True, window=None, q_offset=0):
        return plain_flash(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)

    def scan(r, k, v, logw, u, state0=None, *, chunk=64, state_out=None):
        if state0 is None:
            B, _, H, hd = r.shape
            state0 = torch.zeros((B, H, hd, hd), device=r.device)
        out, st = ref.rwkv6_chunked_ref(r, k, v, logw, u, state0,
                                        min(chunk, r.shape[1]))
        return out, st if state_out is None else state_out.copy_(st)
    ops.flash_attention, ops.rwkv6_scan = flash, scan
    try:
        yield
    finally:
        ops.flash_attention, ops.rwkv6_scan = saved


@contextlib.contextmanager
def nudged_lm_kernels(rel, seed=5):
    """Route the LM's two kernel calls (``kernels.ops.flash_attention`` and
    ``ops.rwkv6_scan``, looked up at call time by the models) through
    themselves with every output moved by ``rel`` relative (Gaussian):
    the model's own spread under float-level noise."""
    import torch
    from repro_torch.kernels import ops
    saved = ops.flash_attention, ops.rwkv6_scan
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def nudge(o):
        noise = torch.randn(o.shape, generator=gen, device=o.device)
        return (o.float() * (1 + rel * noise)).to(o.dtype)

    def flash(*a, **kw):
        return nudge(saved[0](*a, **kw))

    def scan(*a, **kw):
        out, st = saved[1](*a, **kw)
        return nudge(out), st
    ops.flash_attention, ops.rwkv6_scan = flash, scan
    try:
        yield
    finally:
        ops.flash_attention, ops.rwkv6_scan = saved


def profile_device(fn):
    """Wall ms, device busy ms, idle share and top kernels of one call
    (the device's activity only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, n, busy = device_events(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {"wall_ms": wall_ms, "device_kernels": n,
            "device_busy_ms": busy if n else "not measured",
            "device_idle_share": (1 - busy / wall_ms) if n
            else "not measured",
            "top_kernels": [{"name": k[:80], "ms": v[0] / 1e3, "count": v[1]}
                            for k, v in top]}


#: the served LMs, one model at a time: arch -> (phase suffix, depth cut
#: or None); qwen3 and rwkv6 also train (``LM_KERNEL``), the rest of the
#: zoo serves only, the MoE configs cut in depth to fit the card
LM_PHASES = {"qwen3-1.7b": ("qwen3", None), "rwkv6-3b": ("rwkv6", None),
             "mixtral-8x22b": ("mixtral", 8),
             "llama4-maverick-400b-a17b": ("llama4", 1),
             "recurrentgemma-2b": ("recurrentgemma", None),
             "qwen2-vl-2b": ("qwen2vl", None),
             "whisper-base": ("whisper", None)}
ZOO = tuple(a for a in LM_PHASES if a not in LM_KERNEL)
#: whisper's decoder context: its prefill, cache and serve run at T = 448
WHISPER_T = 448
#: decode steps of lm_serve_llama4: each step reads all 128 experts (32 GB)
SERVE_GEN = {"llama4-maverick-400b-a17b": 8}
#: prompt positions over which lm_serve holds decode against forward end
#: to end (None: the whole prompt; 0: none, recorded only); position 0
#: for the archs not listed. The reference's decode differs from its
#: prefill past position 0 for MoE (capacity max(1, int(T k cf / E))
#: drops routes at prefill that decode keeps) and qwen2-vl (prefill puts
#: the vision prefix on a grid, decode advances the three position
#: streams together); rwkv6's 32 random-init bf16 layers are chaotic
SERVE_END_TO_END = {"qwen3-1.7b": None, "rwkv6-3b": 0}
#: archs whose decode is also held against prefill layer by layer over
#: the prompt (teacher forced), where the reference makes them equal
#: (rwkv6 over its first RWKV6_EXACT_PREFIX positions, with the carried
#: state)
PER_LAYER_DECODE = ("rwkv6-3b", "recurrentgemma-2b", "whisper-base")
#: MoE blocks against the plain kernels: a router can flip on a
#: float-level input difference, so the block's update is held in relative
#: L2 within BF16_MODEL_TOL or MOE_FLOOR_FACTOR times the model's own
#: floor, the plain block with every attention output moved by MOE_NUDGE
#: relative (half a bf16 ulp), whichever is larger
MOE_NUDGE = 2.0 ** -9
MOE_FLOOR_FACTOR = 2.0


def lm_model(arch, depth=None):
    """The full-width model (depth cut per ``LM_PHASES``, or to ``depth``),
    bf16 weights drawn on the card from seed 0."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm
    cfg = get_config(arch)
    depth = depth or LM_PHASES[arch][1]
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    params, _ = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    return cfg, params


def lm_extra(cfg, B):
    """The stub frames (whisper) or patches (qwen2-vl) of
    ``make_stub_embeds``, drawn on the card from seed 1; None for a text
    arch."""
    import torch
    from repro_torch.models.frontends import make_stub_embeds
    return make_stub_embeds(torch.Generator(device="cuda").manual_seed(1),
                            cfg, B)


def lm_launches(cfg, decode=False):
    """Kernel launches of one forward (``decode``: of one decode step):
    flash once per attention call (an encoder-decoder's encoder, decoder
    and cross attention each; none at decode, whose attention is plain
    in the reference), the scan once per rwkv6 layer."""
    kinds = [cfg.block_kind(i) for i in range(cfg.n_layers)]
    flash = cfg.n_encoder_layers + 2 * cfg.n_layers if cfg.encdec else \
        sum(k in ("attn", "swa") for k in kinds)
    want = {"flash_attention": 0 if decode else flash,
            "rwkv6_scan": kinds.count("rwkv6")}
    return {k: n for k, n in want.items() if n}


def only_launches(label, launches, want):
    """Fail where a kernel outside ``want`` launched."""
    others = {k: n for k, n in launches.items() if k not in want}
    if others:
        fail(f"{label}: launched {others}, want only {want}")


def rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


@contextlib.contextmanager
def moe_routes():
    """Record ``(top_e, keep)`` of every ``apply_moe`` call (looked up at
    call time by ``transformer._apply_ffn``)."""
    from repro_torch.models import moe
    saved, log = moe.apply_moe, []

    def rec(p, x, cfg):
        r = moe.moe_routing(p, x, cfg)
        log.append((r.top_e, r.keep))
        return saved(p, x, cfg)
    moe.apply_moe = rec
    try:
        yield log
    finally:
        moe.apply_moe = saved


def block_check(p, x, cfg, kind, pos, pos3, enc_out, causal):
    """One block on input x through the kernels and through the plain
    kernels. Returns (kernel output, plain output, record): dense blocks
    hold max|a-b|/max|b| of the update; MoE blocks the update's relative
    L2 against the floor, with the routes and drops that differ."""
    from repro_torch.models.transformer import _apply_block_train

    def run():
        return _apply_block_train(p, x, cfg, kind, pos, pos3, enc_out,
                                  causal)[0]
    with moe_routes() as rk:
        y = run()
    with plain_lm_kernels(), moe_routes() as rp:
        yp = run()
    rec = {"kind": kind if causal else "encoder"}
    if rk:
        with plain_lm_kernels(), nudged_lm_kernels(MOE_NUDGE), \
                moe_routes() as rn:
            yn = run()
        err, floor = rel_l2(y - x, yp - x), rel_l2(yn - x, yp - x)
        (ek, kk), (ep, kp), (en, kn) = rk[0], rp[0], rn[0]
        rec.update(update_rel_l2=err, floor_rel_l2=floor,
                   routes=int(ek.numel()), dropped=int((~kk).sum()),
                   routes_differ=int((ek != ep).sum()),
                   drops_differ=int((kk != kp).sum()),
                   floor_routes_differ=int((en != ep).sum()),
                   floor_drops_differ=int((kn != kp).sum()),
                   ok=err <= max(BF16_MODEL_TOL, MOE_FLOOR_FACTOR * floor))
    else:
        err = norm_err(y.float() - x.float(), yp.float() - x.float())
        rec.update(update_err=err, ok=err <= BF16_MODEL_TOL)
    return y, yp, rec


def teacher_forced(params, cfg, tokens, extra=None):
    """The prefill block by block (the encoder's too): each block runs on
    the kernel path's input through the kernels and through the plain
    kernels (``block_check``), and the next block takes the kernel path's
    output. Returns the blocks' records and the last-position logits'
    error of the two paths' last layer."""
    import torch
    from repro_torch.models.common import rms_norm, sinusoidal_positions
    from repro_torch.models.transformer import (_head, build_mrope_positions,
                                                encoder_params, layer_params)
    B, T = tokens.shape
    x = params["embed"][tokens]
    pos = torch.arange(T, device=x.device)[None].expand(B, T)
    pos3 = None
    if cfg.mrope:
        pos3 = build_mrope_positions(cfg, B, T, device=x.device)
        if extra is not None:
            x = torch.cat([extra.to(x.dtype), x[:, extra.shape[1]:]], 1)
    blocks, enc_out = [], None
    with torch.no_grad():
        if cfg.encdec:
            e = extra.to(x.dtype) + sinusoidal_positions(
                extra.shape[1], cfg.d_model).to(x.device, x.dtype)
            for p in encoder_params(params, cfg):
                e, _, rec = block_check(p, e, cfg, "attn", None, None, None,
                                        False)
                blocks.append(rec)
            enc_out = rms_norm(e, params["enc_norm"], cfg.norm_eps)
        for kind, p in layer_params(params, cfg):
            y, yp, rec = block_check(p, x, cfg, kind, pos, pos3, enc_out,
                                     True)
            blocks.append(rec)
            x = y
        head = _head(params, cfg)
        last = [rms_norm(h[:, -1], params["final_norm"], cfg.norm_eps) @ head
                for h in (y, yp)]
    return blocks, norm_err(*last)


def lm_prefill(arch, cfg, params, totals, B=4, T=4096, reps=3):
    """``make_prefill_step`` at full width (whisper at its 448-token
    decoder context over 1,500 stub frames; qwen2-vl with its 256 stub
    patches): the launches of ``lm_launches`` and no other, ms per
    prefill, peak memory, the device's idle share; every block held
    against the plain kernels (``teacher_forced``), and the whole prefill
    too where the model is neither chaotic in bf16 (rwkv6: the nudge
    floor shows it) nor routed (MoE)."""
    import torch
    from repro_torch.configs import active_param_count, param_count
    from repro_torch.kernels import _build, ops
    from repro_torch.train.trainer import make_prefill_step
    phase = f"lm_prefill_{LM_PHASES[arch][0]}"
    T = WHISPER_T if cfg.encdec else T
    tokens = torch.randint(0, cfg.vocab_size, (B, T),
                           generator=torch.Generator().manual_seed(1)).cuda()
    extra = lm_extra(cfg, B)
    batch = {"tokens": tokens}
    if extra is not None:
        batch["extra"] = extra
    step = make_prefill_step(cfg)
    want = lm_launches(cfg)
    with torch.no_grad():
        step(params, batch)                      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        logits = step(params, batch)
        torch.cuda.synchronize()
        launches, by_shape = count_launches(phase, totals, want)
        only_launches(phase, launches, want)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            step(params, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        prof = profile_device(lambda: step(params, batch))
        blocks, last_err = teacher_forced(params, cfg, tokens, extra)
        # free running: the whole prefill through the plain versions; for
        # the scan (fp32 output) also the plain prefill with every scan
        # output moved by one part in 1e6: the model's own sensitivity
        floor = None
        with plain_lm_kernels():
            plain = step(params, batch)
            if "rwkv6_scan" in want:
                scan = ops.rwkv6_scan

                def nudged(*a, **kw):
                    out, st = scan(*a, **kw)
                    return out * (1 + 1e-6 * torch.randn_like(out)), st
                ops.rwkv6_scan = nudged
                floor = norm_err(step(params, batch), plain)
        torch.cuda.synchronize()
    if logits.shape != (B, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        fail(f"{phase}: logits {tuple(logits.shape)} not finite")
    bad = [i for i, b in enumerate(blocks) if not b["ok"]]
    free = norm_err(logits, plain)
    held = floor is None and not cfg.moe.num_experts
    dense = [b["update_err"] for b in blocks if "update_err" in b]
    ms = median(times)
    rec = {"phase": phase, "arch": arch, "dtype": cfg.dtype,
           "layers": cfg.n_layers, "encoder_layers": cfg.n_encoder_layers,
           "params": sum(int(v.numel()) for v in params.values()),
           "param_count": param_count(cfg),
           "active_param_count": active_param_count(cfg),
           "batch": B, "seq_len": T,
           "extra_embeds": None if extra is None else list(extra.shape),
           "launches": launches, "launches_by_shape": by_shape,
           "launches_want": want,
           "ms_per_prefill": ms, "ms_runs": times,
           "tokens_per_s": B * T / ms * 1e3, "peak_mem_gb": peak_gb,
           "blocks": blocks,
           "layer_update_err_vs_plain": max(dense) if dense else None,
           "last_logits_err_vs_plain": last_err,
           "tolerance": f"dense blocks: max|a-b|/max|b| of the update <= "
                        f"{BF16_MODEL_TOL}, teacher forced; MoE blocks: "
                        f"relative L2 of the update <= max("
                        f"{BF16_MODEL_TOL}, {MOE_FLOOR_FACTOR} x the floor "
                        f"of a {MOE_NUDGE} nudge of the plain attention); "
                        f"last-position logits, and free running where "
                        f"held, <= {BF16_MODEL_TOL}",
           "free_running_err_vs_plain": free,
           "free_running_held": held,
           "free_running_floor_1e-6_nudge": floor,
           "argmax_agree_vs_plain": float(
               (logits.argmax(-1) == plain.argmax(-1)).float().mean()),
           "profile": prof,
           "reduced": ([f"depth {cfg.n_layers} of the published layers"]
                       if LM_PHASES[arch][1] else [])
           + ([f"T = {WHISPER_T} (the decoder's context), not 4096"]
              if cfg.encdec else [])}
    emit(rec)
    if bad:
        fail(f"{phase}: blocks {bad} off the plain kernels: "
             f"{[blocks[i] for i in bad]}")
    if last_err > BF16_MODEL_TOL or (held and free > BF16_MODEL_TOL):
        fail(f"{phase}: last-position logits off the plain kernels' by "
             f"{last_err:.3g} teacher forced, {free:.3g} free running "
             f"(held: {held}; tolerance {BF16_MODEL_TOL})")
    return rec


def teacher_forced_decode(params, cfg, tokens, enc_out=None):
    """Decode against prefill layer by layer: each decoder block takes the
    prefill's input sequence once whole (``_apply_block_train``) and once
    a token at a time through ``_decode_block`` from a zero cache (with
    ``enc_out`` for an encoder-decoder); the next layer takes the prefill
    side's output. Returns the largest error of a block's update, and for
    rwkv6 blocks (else None) of the carried state and last token against
    ``apply_rwkv6``'s carry, each over the prefill side's max."""
    import torch
    from repro_torch.models import rwkv6 as rwkv6_lib
    from repro_torch.models.common import rms_norm, subtree
    from repro_torch.models.transformer import (_apply_block_train,
                                                layer_params)
    from repro_torch.serve.decode import _block_cache, _decode_block
    B, T = tokens.shape
    x = params["embed"][tokens]
    pos = torch.arange(T, device=x.device)[None].expand(B, T)
    upd, s_err, l_err = 0.0, None, None
    with torch.no_grad():
        for kind, p in layer_params(params, cfg):
            y, _ = _apply_block_train(p, x, cfg, kind, pos, None, enc_out)
            cache, _ = _block_cache(cfg, kind, B, T, x.device)
            ys = []
            for t in range(T):
                yt, cache = _decode_block(p, x[:, t:t + 1], cfg, kind, cache,
                                          t, enc_out=enc_out)
                ys.append(yt)
            yd = torch.cat(ys, dim=1)
            upd = max(upd, norm_err(yd.float() - x.float(),
                                    y.float() - x.float()))
            if kind == "rwkv6":
                _, (s_ref, last_ref) = rwkv6_lib.apply_rwkv6(
                    subtree(p, "tmix"), rms_norm(x, p["norm1"],
                                                 cfg.norm_eps), cfg)
                s_err = max(s_err or 0.0, norm_err(cache["s"], s_ref))
                l_err = max(l_err or 0.0, norm_err(cache["last"], last_ref))
            x = y
    return upd, s_err, l_err


def lm_serve(arch, cfg, params, totals, B=8, P=128, G=32, L=4096):
    """The greedy driver ``generate`` (whisper: a 448 cache, decoding
    against the 1,500 stub frames as the JAX serve script does): ms per
    decode step, tokens/s, and the launches of ``lm_launches(decode=True)``
    a step and no other. Then decode against forward end to end over the
    prompt positions of ``SERVE_END_TO_END`` (whisper's with ``enc_out``
    the encoder's output over the frames), and layer by layer over the
    prompt for ``PER_LAYER_DECODE`` (``teacher_forced_decode``)."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import encode, forward
    from repro_torch.serve.decode import init_decode_state, serve_step
    phase = f"lm_serve_{LM_PHASES[arch][0]}"
    G = SERVE_GEN.get(arch, G)
    L = WHISPER_T if cfg.encdec else L
    per_step = lm_launches(cfg, decode=True)
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                              size=(B, P)).astype(np.int32)
    stub = lm_extra(cfg, B) if cfg.encdec else None
    generate(params, cfg, prompt[:, :2], 2, 64, enc_out=stub)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    res = generate(params, cfg, prompt, G, L, enc_out=stub)
    launches, _ = count_launches(
        phase, totals, {k: n * (P + G) for k, n in per_step.items()})
    only_launches(phase, launches, per_step)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if res.tokens.shape != (B, G) or not torch.isfinite(res.logits).all() \
            or int(res.tokens.min()) < 0 \
            or int(res.tokens.max()) >= cfg.vocab_size:
        fail(f"{phase}: bad tokens {tuple(res.tokens.shape)} or non-finite "
             f"logits")
    # the positions decoded through serve_step, and those held end to end
    decoded = P if arch in SERVE_END_TO_END else 1
    held = SERVE_END_TO_END.get(arch, 1)
    held = decoded if held is None else held
    toks = torch.from_numpy(prompt).cuda()
    upd = s_err = l_err = None
    with torch.no_grad():
        enc_out = encode(params, cfg, stub)[0] if cfg.encdec else None
        state, _ = init_decode_state(cfg, B, L)
        if cfg.encdec:
            state["enc_out"] = enc_out
        _build.reset_launch_counts()
        dec = []
        for t in range(decoded):
            logits, state = serve_step(params, cfg, state, toks[:, t:t + 1])
            dec.append(logits)
        step_launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        dec = torch.cat(dec, dim=1)
        fwd, _ = forward(params, cfg, toks[:, :decoded], stub)
        prof = profile_device(
            lambda: serve_step(params, cfg, state, toks[:, :1]))
        err = norm_err(dec, fwd)
        held_err = norm_err(dec[:, :held], fwd[:, :held]) if held else None
        if arch in PER_LAYER_DECODE:
            n = RWKV6_EXACT_PREFIX if "rwkv6" in cfg.block_pattern else P
            upd, s_err, l_err = teacher_forced_decode(params, cfg,
                                                      toks[:, :n], enc_out)
    if step_launches != {k: n * decoded for k, n in per_step.items()}:
        fail(f"{phase}: {step_launches} over {decoded} decode steps, want "
             f"{per_step} per step")
    rec = {"phase": phase, "arch": arch, "batch": B, "prompt": P, "gen": G,
           "cache_len": L, "layers": cfg.n_layers,
           "ms_per_decode_step": res.decode_s / G * 1e3,
           "tokens_per_s": B * G / res.decode_s,
           "ms_per_prompt_step": res.prefill_s / P * 1e3,
           "launches": launches,
           "launches_per_decode_step": {k: v / decoded for k, v in
                                        step_launches.items()},
           "peak_mem_gb": peak_gb,
           "decode_vs_forward_positions": decoded,
           "decode_vs_forward_err": err,
           "end_to_end_held_positions": held,
           "end_to_end_held_err": held_err,
           "decode_vs_prefill_layer_err": upd,
           "state_vs_prefill_err": s_err, "last_vs_prefill_err": l_err,
           "tolerance": f"max|a-b|/max|b| <= {BF16_MODEL_TOL}",
           "first_tokens": res.tokens[0, :8].tolist(),
           "profile_decode_step": prof,
           "reduced": ([f"depth {cfg.n_layers} of the published layers"]
                       if LM_PHASES[arch][1] else [])
           + ([f"gen {G}, not 32"] if G != 32 else [])
           + ([f"cache {L} (the decoder's context)"] if cfg.encdec
              else [])}
    emit(rec)
    worst = max(x or 0.0 for x in (held_err, upd, s_err, l_err))
    if worst > BF16_MODEL_TOL:
        fail(f"{phase}: decode off forward by {held_err} end to end over "
             f"{held} positions; per layer: update {upd}, state {s_err}, "
             f"last token {l_err} (tolerance {BF16_MODEL_TOL})")
    return rec


#: lm_card_vs_cpu: the served LMs at full width in fp32, cut in depth
#: (recurrentgemma to 3 layers, so that its first swa layer, hd 256, runs;
#: whisper 2 + 2). llama4 is left out: one fp32 layer is 73 GB
CARD_CPU_DEPTH = {"qwen3-1.7b": {"n_layers": 2},
                  "rwkv6-3b": {"n_layers": 2},
                  "mixtral-8x22b": {"n_layers": 1},
                  "recurrentgemma-2b": {"n_layers": 3},
                  "qwen2-vl-2b": {"n_layers": 2},
                  "whisper-base": {"n_layers": 2, "n_encoder_layers": 2}}


def lm_card_vs_cpu(T=256):
    """The served LMs at full width, cut in depth (``CARD_CPU_DEPTH``),
    fp32: the card's logits (through the kernels, the CUDA-core flash
    kernel) against the port's CPU run (the plain versions) on the same
    weights (drawn on the card from seed 0 and copied to the host) and
    stub, with the launches of ``lm_launches`` and no other."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import forward, init_lm
    out = {}
    for arch, over in CARD_CPU_DEPTH.items():
        cfg = dataclasses.replace(get_config(arch), dtype="float32", **over)
        card, _ = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg,
                          device="cuda")
        cpu = {k: v.cpu() for k, v in card.items()}
        toks = torch.from_numpy(np.random.RandomState(2).randint(
            0, cfg.vocab_size, (1, T)))
        extra = lm_extra(cfg, 1)
        want_launches = lm_launches(cfg)
        t0 = time.perf_counter()
        with torch.no_grad():
            _build.reset_launch_counts()
            with moe_routes() as rk:
                got, _ = forward(card, cfg, toks.cuda(), extra)
            torch.cuda.synchronize()
            launches = {k: v for k, v in _build.LAUNCHES.items() if v}
            t1 = time.perf_counter()
            with moe_routes() as rc:
                want, _ = forward(cpu, cfg, toks,
                                  None if extra is None else extra.cpu())
            t2 = time.perf_counter()
        if launches != want_launches:
            fail(f"lm_card_vs_cpu {arch}: launched {launches}, want "
                 f"{want_launches}")
        flips = sum(int((a[0].cpu() != b[0]).sum()) for a, b in zip(rk, rc))
        got = got.cpu()
        err = float((got - want).abs().max())
        out[arch] = {"layers": cfg.n_layers, "max_abs_err": err,
                     "logit_max": float(want.abs().max()),
                     "launches": launches,
                     "moe_routes_differ": flips if rk else None,
                     "card_s": t1 - t0, "cpu_s": t2 - t1}
        del cpu, card
        if not torch.allclose(got, want, rtol=CARD_CPU_RTOL,
                              atol=CARD_CPU_ATOL):
            emit({"phase": "lm_card_vs_cpu", "archs": out})
            fail(f"lm_card_vs_cpu {arch}: logits off the CPU run by "
                 f"{err:.3g} (rtol {CARD_CPU_RTOL}, atol {CARD_CPU_ATOL})")
    emit({"phase": "lm_card_vs_cpu", "dtype": "float32",
          "batch": 1, "seq_len": T,
          "tolerance": f"rtol {CARD_CPU_RTOL}, atol {CARD_CPU_ATOL}",
          "archs": out,
          "reduced": ["depth: qwen3, rwkv6 and qwen2-vl 2 layers, mixtral "
                      "1, recurrentgemma 3, whisper 2 + 2; llama4 left "
                      "out (73 GB a fp32 layer)"]})
    return out


#: pca_cnn: benchmarks/fig1_pca.py's loop (paper CNN, mixture data n=1024,
#: 8 minibatches of 128 an epoch, lr 0.05, 30 epochs, seed 0)
PCA_EPOCHS = 30
#: where the card's and the CPU's N-PCA differ, the cumulative share of
#: the singular values at the flip must lie this close to the threshold
PCA_FLIP_TOL = 1e-4
#: each epoch's accumulated fp32 gradient on the card (TF32 off) against
#: the fp64 one at the same params and minibatches: relative L2. An
#: epoch's sum of 8 minibatch means cancels, so fp32 rounding alone put
#: it up to 5.0e-4 off on the card and 2.2e-4 on the CPU over 30 epochs
#: (the trajectory, and so the worst epoch, differs from run to run;
#: NVIDIA H100 80GB HBM3, 700 W): the limit is 10x the largest seen, and
#: a gradient wrong by 2% fails by 4x
PCA_GRAD_RTOL = 5e-3


def pca_run(epochs=PCA_EPOCHS, seed=0):
    """fig1's loop through the port, the SGD on the card and the tracker
    on the host, teacher forced: every step's gradient also on the CPU at
    the card's params and minibatch, into a second tracker (free running,
    240 SGD steps part the two trajectories by more than float level),
    and in fp64 on the card. Returns (card tracker, CPU tracker, each
    epoch's fp64 gradient, card ms per epoch)."""
    import numpy as np
    import torch
    from repro_torch.analysis.pca import GradientSpaceTracker
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import mixture_classification
    from repro_torch.models.smallnets import (apply_cnn, classifier_loss,
                                              init_cnn)
    cfg = get_config("paper-cnn")
    params, _ = init_cnn(torch.Generator().manual_seed(seed), cfg)
    params = {k: v.cuda() for k, v in params.items()}
    x, y = mixture_classification(1024, 10, seed=seed)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    xc, yc = x.cuda(), y.cuda()
    names = sorted(params)

    def grads(p, xb, yb):
        p = {k: v.detach().requires_grad_() for k, v in p.items()}
        loss, _ = classifier_loss(apply_cnn, p, cfg, xb, yb)
        return dict(zip(names, torch.autograd.grad(loss, [p[k]
                                                          for k in names])))
    lr = 0.05
    card, cpu = GradientSpaceTracker(), GradientSpaceTracker()
    rng = np.random.RandomState(seed)
    card_s, exact = 0.0, []
    for _ in range(epochs):
        acc = {k: torch.zeros_like(v) for k, v in params.items()}
        acc_cpu = {k: torch.zeros_like(v, device="cpu")
                   for k, v in params.items()}
        acc64 = {k: torch.zeros_like(v, dtype=torch.float64)
                 for k, v in params.items()}
        for _ in range(8):
            idx = torch.from_numpy(rng.randint(0, x.shape[0], 128))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = grads(params, xc[idx.cuda()], yc[idx.cuda()])
            with torch.no_grad():
                for k in names:
                    acc[k] += g[k]
            torch.cuda.synchronize()
            card_s += time.perf_counter() - t0
            gc = grads({k: v.cpu() for k, v in params.items()}, x[idx],
                       y[idx])
            g64 = grads({k: v.double() for k, v in params.items()},
                        xc[idx.cuda()].double(), yc[idx.cuda()])
            with torch.no_grad():
                for k in names:
                    acc_cpu[k] += gc[k]
                    acc64[k] += g64[k]
                params = {k: params[k] - lr * g[k] for k in names}
        t0 = time.perf_counter()
        card.add(acc)
        card_s += time.perf_counter() - t0
        cpu.add(acc_cpu)
        exact.append(np.concatenate([acc64[k].cpu().numpy().ravel()
                                     for k in names]))
    return card, cpu, exact, card_s / epochs * 1e3


def pca_flip_share(tracker, epoch, a, b):
    """The cumulative singular-value share after min(a, b) components of
    ``epoch``'s stack, where two runs' N-PCA are a and b: one run puts it
    just below the threshold, the other at or above it."""
    import numpy as np
    sv = np.linalg.svd(np.stack(tracker.grads[:epoch + 1]),
                       compute_uv=False)
    return float((np.cumsum(sv) / max(np.sum(sv), 1e-30))[min(a, b) - 1])


def pca_cnn():
    """The paper's gradient-space PCA (fig. 1) through the port: the CNN's
    per-epoch gradients on the card, the tracker on the host; held against
    the CPU's gradients at the same params (teacher forced): every epoch's
    accumulated gradient within PCA_GRAD_RTOL of the fp64 one, and
    N95/N99 per epoch equal to the CPU's fp32 run's, or where an entry
    differs, the cumulative share at the flip within PCA_FLIP_TOL of the
    threshold."""
    import numpy as np
    card, cpu, exact, ms = pca_run()

    def errs(run):
        return [float(np.linalg.norm(a - b) / np.linalg.norm(b))
                for a, b in zip(run.grads, exact)]
    grad_err, cpu_err = errs(card), errs(cpu)
    flips = []
    for name, var in (("n95", 0.95), ("n99", 0.99)):
        for e, (a, b) in enumerate(zip(getattr(card, name),
                                       getattr(cpu, name))):
            if a != b:
                share = pca_flip_share(card, e, a, b)
                flips.append({"list": name, "epoch": e, "card": a, "cpu": b,
                              "share": share,
                              "ok": abs(share - var) <= PCA_FLIP_TOL})
    rec = {"phase": "pca_cnn", "epochs": PCA_EPOCHS, "model": "paper-cnn",
           "data": "mixture n=1024, 8 minibatches of 128 an epoch, lr "
                   "0.05, seed 0",
           "n95": card.n95, "n99": card.n99, "n95_cpu": cpu.n95,
           "n99_cpu": cpu.n99,
           "equal": card.n95 == cpu.n95 and card.n99 == cpu.n99,
           "flips": flips, "ms_per_epoch": ms,
           "grad_rel_err_vs_fp64_by_epoch": grad_err,
           "cpu_fp32_grad_rel_err_vs_fp64_by_epoch": cpu_err,
           "low_rank": card.n99[-1] < PCA_EPOCHS // 2,
           "held": "teacher forced: each step's CPU gradient at the card's "
                   "params and minibatch",
           "tolerance": f"each epoch's gradient relative L2 to the "
                        f"fp64 one <= {PCA_GRAD_RTOL}; lists equal "
                        f"to the CPU fp32 run's, or the cumulative "
                        f"share at a flip within {PCA_FLIP_TOL} of the "
                        f"threshold"}
    emit(rec)
    if max(grad_err) > PCA_GRAD_RTOL:
        fail(f"pca_cnn: an epoch's gradient off the fp64 one by "
             f"{max(grad_err):.3g} relative L2 (tolerance {PCA_GRAD_RTOL})")
    if not all(f["ok"] for f in flips):
        fail(f"pca_cnn: N-PCA off the CPU's away from a threshold: "
             f"{flips}")
    return rec


def flash_entry(gen, errs, B=4, T=4096):
    """The flash kernel at qwen3-1.7b's prefill call: B=4, Hq 16, Hkv 8,
    T 4096, hd 128, bf16, causal (the tensor-core kernel; fp32 inputs run
    the CUDA-core kernel of flash_attention.cu)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    Hq, Hkv, hd = 16, 8, 128
    q = torch.randn((B, T, Hq, hd), generator=gen).bfloat16().cuda()
    k, v = (torch.randn((B, T, Hkv, hd), generator=gen).bfloat16().cuda()
            for _ in range(2))
    # the (q, k) pairs the causal mask keeps: 2 flops each for q.k and
    # for p.v per head dim
    flops = 4 * hd * (T * (T + 1) // 2) * B * Hq
    bnd, by = bound_ms(2 * B * T * hd * (2 * Hq + 2 * Hkv), flops,
                       bf16=True)
    g = Hq // Hkv
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
              for x in (k, v))
    ms = time_ms(lambda: fa.flash_attention(q, k, v))
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:64",
        "launches": None,
        "max_abs_err": errs["flash_attention"],
        "shape": [B, T, Hq, Hkv, hd], "dtype": "bfloat16",
        "ms": ms,
        "device_kernels_per_call": kernels_per_call(
            lambda: fa.flash_attention(q, k, v)),
        "tflops_counted": flops / ms / 1e9,
        "note": "tflops_counted: the causal mask's q.k and p.v flops over "
                "ms; the kernel issues 1.5x them (P.V as hi.V + lo.V)",
        "plain_ms": time_ms(lambda: ref.flash_attention_gqa_ref(q, k, v)),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "library_call": "torch.nn.functional.scaled_dot_product_attention "
                        "(is_causal; kv heads repeated before timing; "
                        "bf16 P.V)",
        "fp32_kernel": {"source": "src/repro_torch/kernels/csrc/"
                                  "flash_attention.cu",
                        "ms": time_ms(lambda: fa.flash_attention(
                            q.float(), k.float(), v.float()), n=5)},
        "shapes": [dict(flash_shape_record(gen, *shp[:8]),
                        **({"launches_per": shp[8]} if shp[8] else {}))
                   for shp in FLASH_SHAPES]}


def band_pairs(T, window):
    """(q, k) pairs a causal mask with ``window`` keeps over T positions."""
    W = min(window, T)
    return W * (W + 1) // 2 + (T - W) * W


def flash_shape_record(gen, B, Tq, Tk, Hq, Hkv, hd, causal=True,
                       window=None):
    """The flash kernel at one call shape of the main path (bf16): ms,
    bound (the pairs the mask keeps), the plain version's ms and SDPA's
    (kv heads repeated before timing; a boolean band mask where a window
    cuts the causal band). ``launches`` is filled in from the main path's
    per-shape counts."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q = torch.randn((B, Tq, Hq, hd), generator=gen).bfloat16().cuda()
    k, v = (torch.randn((B, Tk, Hkv, hd), generator=gen).bfloat16().cuda()
            for _ in range(2))
    pairs = band_pairs(Tk, window or Tk) if causal else Tq * Tk
    flops = 4 * hd * pairs * B * Hq
    bnd, by = bound_ms(2 * B * hd * (2 * Tq * Hq + 2 * Tk * Hkv), flops,
                       bf16=True)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
              .contiguous() for x in (k, v))
    sdpa = dict(is_causal=causal)
    lib = "scaled_dot_product_attention"
    if causal and window is not None and window < Tk:
        pos = torch.arange(Tk, device="cuda")
        sdpa = dict(attn_mask=(pos[:, None] >= pos[None, :])
                    & (pos[:, None] - pos[None, :] < window))
        lib += f" with a boolean causal band mask (window {window})"
    else:
        lib += " (is_causal)" if causal else " (no mask)"
    call = lambda: fa.flash_attention(q, k, v, causal=causal, window=window)
    ms = time_ms(call)
    return {"shape": [B, Tq, Tk, Hq, Hkv, hd], "causal": causal,
            "window": window, "dtype": "bfloat16", "launches": None,
            "ms": ms, "tflops_counted": flops / ms / 1e9,
            "device_kernels_per_call": kernels_per_call(call),
            "plain_ms": time_ms(lambda: ref.flash_attention_gqa_ref(
                q, k, v, causal=causal, window=window), n=5),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, **sdpa)),
            "library_call": f"{lib}; kv heads repeated {Hq // Hkv}x before "
                            f"timing",
            "fp32_kernel_ms": time_ms(lambda: fa.flash_attention(
                q.float(), k.float(), v.float(), causal=causal,
                window=window), n=5)}


#: the kernels line's flash shapes: recurrentgemma-2b's prefill call (its
#: local attention: Hq 10 over 1 kv head, hd 256, window 2048), then the
#: training calls of recurrentgemma (b=1, T 2048) and of whisper's cross
#: attention (b=2, Tq 448 over 1,500 frames, not causal), whose launches
#: are per training step
FLASH_SHAPES = ((4, 4096, 4096, 10, 1, 256, True, 2048, None),
                (1, 2048, 2048, 10, 1, 256, True, 2048, "training step"),
                (2, WHISPER_T, 1500, 8, 8, 64, False, None, "training step"))


def flash_single_bf16_p(B=4, T=4096):
    """A finding, not a check, and not on the main path: on the main
    path's flash call (qwen3: Hq 16, Hkv 8, hd 128, bf16, causal), the
    largest error and the elements past the bf16 check's tolerance of P.V
    with p rounded once to bf16 (as scaled_dot_product_attention and the
    JAX model path do), beside the kernel's hi/lo split emulated the same
    way and the kernel itself, all against the fp32 plain version.
    Plain PyTorch on the card, one batch row at a time."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    Hq, Hkv, hd = 16, 8, 128
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((B, T, Hq, hd), generator=gen).bfloat16().cuda()
    k, v = (torch.randn((B, T, Hkv, hd), generator=gen).bfloat16().cuda()
            for _ in range(2))
    kern = fa.flash_attention(q, k, v)
    out = {"single_bf16_p": [0.0, 0], "hi_lo_split": [0.0, 0],
           "kernel": [0.0, 0]}
    mask = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
    for b in range(B):
        want = ref.flash_attention_gqa_ref(q[b:b + 1].float(),
                                           k[b:b + 1].float(),
                                           v[b:b + 1].float())[0]
        qf = q[b].float().transpose(0, 1)
        kf, vf = (x[b].float().transpose(0, 1).repeat_interleave(
            Hq // Hkv, 0) for x in (k, v))
        s = (qf @ kf.transpose(1, 2)) / hd ** 0.5
        s = torch.where(mask, s, ref.NEG_INF)
        p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        del s
        l = p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        emul = {"single_bf16_p": (hi @ vf) / l,
                "hi_lo_split": (hi @ vf + (p - hi).bfloat16().float() @ vf)
                / l}
        del p, hi
        emul = {n: o.transpose(0, 1).bfloat16() for n, o in emul.items()}
        emul["kernel"] = kern[b]
        for name, got in emul.items():
            d = (got.float() - want).abs()
            bad = d > FLASH_ATOL_BF16 + FLASH_RTOL_BF16 * want.abs()
            out[name][0] = max(out[name][0], float(d.max()))
            out[name][1] += int(bad.sum())
        del emul, want
    torch.cuda.synchronize()
    rec = {"phase": "flash_single_bf16_p", "check": False,
           "shape": [B, T, Hq, Hkv, hd], "elements": B * T * Hq * hd,
           "tolerance": f"rtol 2^-7, atol {FLASH_ATOL_BF16} per element vs "
                        f"the fp32 plain version (the kernel's check)"}
    for name, (err, bad) in out.items():
        rec[name] = {"max_abs_err": err, "elements_past_tolerance": bad}
    emit(rec)
    return rec


def scan_entry(gen, errs, B=4, T=4096):
    """The scan kernels at rwkv6-3b's prefill call: B=4, H 40, T 4096,
    hd 64, fp32, from a zero state; and at its decode call (B=8, T=1, a
    random state), as serving makes it: the state updated in place."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rs
    H, hd = 40, 64
    ins = scan_inputs(gen, B, T, H, hd, "zeros", "model")
    c = rs.CHUNK
    bnd, by = scan_bound(B, T, H, hd)
    Bd = 8
    dec = scan_inputs(gen, Bd, 1, H, hd, "random", "model")
    cache = dec[5].clone()
    # decode: the state in and out, r, k, v, log decay in, u, out; per head
    # r.S and the update S e^lw + k v^T (5 hd^2), the bonus and exps
    dec_bnd, dec_by = bound_ms(
        2 * Bd * H * hd * hd * 4 + 5 * Bd * H * hd * 4 + H * hd * 4,
        Bd * H * (5 * hd * hd + 6 * hd))
    return {
        "name": "rwkv6_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:56",
        "launches": None,
        "device_kernels_per_call": kernels_per_call(
            lambda: rs.rwkv6_scan(*ins)),
        "max_abs_err": errs["rwkv6_scan"],
        "shape": [B, T, H, hd], "dtype": "float32",
        "ms": time_ms(lambda: rs.rwkv6_scan(*ins)),
        "plain_ms": time_ms(lambda: ref.rwkv6_chunked_ref(*ins, c)),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes the "
                        "chunked WKV recurrence",
        "decode_T1": {
            "shape": [Bd, 1, H, hd],
            "ms": time_ms(lambda: rs.rwkv6_scan(*dec[:5], cache,
                                                state_out=cache)),
            "device_kernels_per_call": kernels_per_call(
                lambda: rs.rwkv6_scan(*dec[:5], cache, state_out=cache)),
            "ms_fresh_state": time_ms(lambda: rs.rwkv6_scan(*dec)),
            "plain_ms": time_ms(lambda: ref.rwkv6_chunked_ref(*dec, 1)),
            "bound_ms": dec_bnd, "bound_by": dec_by,
            "note": "ms: state updated in place (state_out=state0), as "
                    "serve_step calls it; ms_fresh_state writes a new "
                    "state tensor"}}


# ------------------------------------------------------------ LM training

#: the training runs of ``launch.train.main`` at full width (replicated, the
#: dense "full" store, bf16, remat): arch -> (--clients, --batch, --seq,
#: --steps). K is cut from the configs' 16: K dense LBG banks must fit
#: beside the model (recurrentgemma's 3.55 billion bf16 params: K=2);
#: whisper runs at its 448-token decoder context; rwkv6's host-bound
#: steps (~9 s) run 2
TRAIN_RUNS = {"qwen3-1.7b": (4, 2, 2048, 3), "rwkv6-3b": (2, 2, 2048, 2),
              "recurrentgemma-2b": (2, 1, 2048, 3),
              "qwen2-vl-2b": (4, 1, 2048, 3),
              "whisper-base": (4, 2, WHISPER_T, 3)}
#: the flags every training run shares
TRAIN_FLAGS = ["--pool", "1", "--delta", "0.6", "--lr", "0.05",
               "--log-every", "1"]
TRAIN_DELTA = 0.6
#: training runs held end to end against the plain kernels' run (rwkv6's
#: 32 random-init bf16 layers are chaotic: it is held layer by layer only)
TRAIN_VS_PLAIN = ("qwen3-1.7b", "recurrentgemma-2b", "qwen2-vl-2b",
                  "whisper-base")
#: the top-k training phases: ``make_train_step`` in fsdp with the top-k
#: store at k_frac 0.01, from the card's seed-0 weights: arch -> (phase,
#: depth or None, K, b, T, steps, the leaf whose decision on step 2's
#: gradient is held exactly against the plain version and timed, held end
#: to end against the plain kernels' run). mixtral is cut in depth only,
#: to 1 of 56 layers (2.9 billion params; its expert leaves 805 million
#: elements each): at 2 layers a top-k step holds 10.6 GB of bf16 params,
#: the 21 GB fp32 accumulator, a client's 10.6 GB gradient, its 21 GB
#: dense fp32 reconstruction and a 6.4 GB scatter buffer, and ran out of
#: the card's memory (NVIDIA H100 80GB HBM3, 700 W), as did its FL round
TOPK_RUNS = {"qwen3-1.7b": ("lm_train_topk_qwen3", None, 4, 2, 2048, 2,
                            "embed", False),
             "mixtral-8x22b": ("lm_train_mixtral", 1, 2, 1, 2048, 2,
                               "blocks/moe/w_gate", True)}
#: the Function's forward + backward against the plain forward + autograd:
#: bf16 (the plain side in fp32 on the bf16 inputs) each gradient within
#: 2e-2 of its max |.|; fp32 within 1e-3 of its max |.|
TRAIN_GRAD_TOL_BF16 = 2e-2
TRAIN_GRAD_TOL_FP32 = 1e-3
#: a bf16 training step against the plain kernels' run: step 1's loss
#: (rtol) and aggregated update (relative L2); decisions are held where
#: sin² lies farther than TRAIN_MARGIN from delta in both runs. The
#: update is held at TRAIN_UPDATE_RTOL or, where larger, at twice the
#: model's own floor measured in the same call: the plain run against
#: itself with every attention output moved by 2^-9 relative (half a bf16
#: ulp), which moves qwen3's step-1 update by 2.6% (NVIDIA H100, 700 W)
TRAIN_LOSS_RTOL = 2e-3
TRAIN_UPDATE_RTOL = 2e-2
TRAIN_UPDATE_FLOOR_FACTOR = 2.0
TRAIN_NUDGE = 2.0 ** -9
TRAIN_MARGIN = 1e-2
#: card against CPU in fp32 at depth 2
TRAIN_CPU_LOSS_RTOL = 1e-4
TRAIN_CPU_UPDATE_RTOL = 1e-3
TRAIN_CPU_MARGIN = 1e-5
#: the zoo's flash calls in training, held forward and backward against
#: the plain version under autograd (bf16): (B, Tq, Tk, Hq, Hkv, hd,
#: causal, window) of recurrentgemma's local attention, qwen2-vl's,
#: whisper's encoder, decoder self and cross attention, mixtral's
TRAIN_FLASH_CASES = ((1, 2048, 2048, 10, 1, 256, True, 2048),
                     (1, 2048, 2048, 12, 2, 128, True, None),
                     (2, 1500, 1500, 8, 8, 64, False, None),
                     (2, WHISPER_T, WHISPER_T, 8, 8, 64, True, None),
                     (2, WHISPER_T, 1500, 8, 8, 64, False, None),
                     (1, 2048, 2048, 48, 8, 128, True, 4096))
#: per training step, launches per kernel and call shape (the kernels
#: line's training shapes read them)
TRAIN_SHAPES = {}


def grads_vs_plain(kernel_fn, plain_fn, ins, ups, plain_ins=None,
                   plain_ups=None):
    """Outputs and input gradients of ``kernel_fn`` (the autograd
    Function) and of ``plain_fn`` under autograd, each on its own copies
    of the inputs and upstream gradients."""
    import torch

    def run(fn, xs, gs):
        xs = [x.detach().clone().requires_grad_() for x in xs]
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return ([o.detach() for o in outs],
                torch.autograd.grad(outs, xs, gs))
    return (run(kernel_fn, ins, ups),
            run(plain_fn, plain_ins or ins, plain_ups or ups))


def lbgm_table_check(arch):
    """The projection over one client's table of every leaf of the
    full-width model, as each training step of ``arch`` calls it (one
    client, the leaves (1, n_i) in sorted key order; rwkv6-3b: 3.60
    billion bf16 elements, recurrentgemma-2b 3.55 billion, past 2^31),
    the params as g and a random l, against its plain version (each
    leaf's sums added in sorted key order) within 1e-5 of the sum of
    |terms|; its time beside the plain version's and the bound. The
    record also goes into the kernels line's training shapes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models.transformer import init_lm
    cfg = get_config(arch)
    g, _ = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg,
                   device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    l = {k: torch.randn(v.shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16) * 0.02 for k, v in g.items()}
    g1 = {k: v[None] for k, v in g.items()}
    l1 = {k: v[None] for k, v in l.items()}
    got = ops.lbgm_projection(g1, l1)
    names = sorted(g)
    want = scale = None
    for k in names:
        a, b = g[k].reshape(1, -1), l[k].reshape(1, -1)
        part = ref.lbgm_projection_ref(a, b)
        sc = ref.lbgm_projection_ref(a.abs(), b.abs())
        want = part if want is None else tuple(x + y for x, y in
                                               zip(want, part))
        scale = sc if scale is None else tuple(x + y for x, y in
                                               zip(scale, sc))
    torch.cuda.synchronize()
    n = sum(int(v.numel()) for v in g.values())
    err = max(float((a - w).abs().max()) for a, w in zip(got, want))
    ok = all(bool(((a - w).abs() <= 1e-5 * s).all())
             for a, w, s in zip(got, want, scale))
    bnd, by = bound_ms(2 * n * 2 + 3 * 4, 6 * n)
    gs = [g1[k].reshape(1, -1) for k in names]
    ls = [l1[k].reshape(1, -1) for k in names]
    rec = {"arch": arch, "shape": [[1, int(x.shape[1])] for x in gs],
           "elements": n, "leaves": len(names),
           "dtype": "bfloat16", "max_abs_err": err,
           "ms": time_ms(lambda: ops.lbgm_projection(g1, l1), n=5),
           "plain_ms": time_ms(lambda: sum_leaves(ref.lbgm_projection_ref,
                                                  gs, ls), n=3),
           "bound_ms": bnd, "bound_by": by, "library_ms": None,
           "library_call": "none: no one PyTorch call takes a table of "
                           "leaves, and the concatenated table passes "
                           "2^31 elements for two of these archs",
           "tolerance": "1e-5 of the sum of |terms|"}
    TRAIN_SHAPE_RECORDS.append(("lbgm_projection", rec))
    if not ok:
        fail(f"lm_train_kernel_checks: the projection over {arch}'s table "
             f"of {n} elements is off its plain version by {err:.3g}")
    del g, l, g1, l1, gs, ls
    torch.cuda.empty_cache()
    return rec


def lm_train_kernel_checks():
    """The two differentiable LM kernels (forward: the kernel; backward:
    plain PyTorch) against the plain forward under autograd on the card,
    at the training shapes (qwen3: B=2, T=2048, Hq 16, Hkv 8, hd 128,
    bf16; rwkv6: B=2, T=2048, H 40, hd 64, fp32) and flash in fp32; the
    backward passes' times beside their bounds (and SDPA's backward as a
    yardstick); the projection over the leaf table of every arch of
    ``TRAIN_RUNS``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rs
    gen = torch.Generator().manual_seed(11)
    rec = {"phase": "lm_train_kernel_checks"}
    B, T, Hq, Hkv, hd = 2, 2048, 16, 8, 128
    for dtype, shape in ((torch.bfloat16, (B, T, Hq, Hkv, hd)),
                         (torch.float32, (1, 512, 16, 8, 64))):
        b, t, hq, hkv, d = shape
        q = torch.randn((b, t, hq, d), generator=gen).to(dtype).cuda()
        k, v = (torch.randn((b, t, hkv, d), generator=gen).to(dtype).cuda()
                for _ in range(2))
        do = torch.randn((b, t, hq, d), generator=gen).to(dtype).cuda()
        (o, gk), (po, gp) = grads_vs_plain(
            fa.flash_attention, ref.flash_attention_gqa_ref, [q, k, v],
            [do], [x.float() for x in (q, k, v)], [do.float()])
        errs = {n: norm_err(a, w) for n, a, w in zip(("dq", "dk", "dv"),
                                                     gk, gp)}
        tol = TRAIN_GRAD_TOL_BF16 if dtype == torch.bfloat16 \
            else TRAIN_GRAD_TOL_FP32
        name = "flash_bf16" if dtype == torch.bfloat16 else "flash_fp32"
        rec[name] = {"shape": list(shape), "grad_err": errs,
                     "out_err": norm_err(o[0], po[0]),
                     "tolerance": f"max|a-b| <= {tol} max|b|, each gradient"}
        if max(errs.values()) > tol:
            fail(f"lm_train_kernel_checks {name}: gradients off the plain "
                 f"autograd by {errs} of their max (tolerance {tol})")
    # the zoo's training calls: hd 256 with a window, the new head maps,
    # whisper's non-causal encoder and cross attention (Tq 448, Tk 1500)
    rec["flash_zoo_bf16"] = []
    for b, tq, tk, hq, hkv, d, causal, window in TRAIN_FLASH_CASES:
        q = torch.randn((b, tq, hq, d), generator=gen).bfloat16().cuda()
        k, v = (torch.randn((b, tk, hkv, d), generator=gen).bfloat16().cuda()
                for _ in range(2))
        do = torch.randn((b, tq, hq, d), generator=gen).bfloat16().cuda()
        mask = dict(causal=causal, window=window)
        (o, gk), (po, gp) = grads_vs_plain(
            lambda *a: fa.flash_attention(*a, **mask),
            lambda *a: ref.flash_attention_gqa_ref(*a, **mask), [q, k, v],
            [do], [x.float() for x in (q, k, v)], [do.float()])
        errs = {n: norm_err(a, w) for n, a, w in zip(("dq", "dk", "dv"),
                                                     gk, gp)}
        rec["flash_zoo_bf16"].append({
            "shape": [b, tq, tk, hq, hkv, d], **mask, "grad_err": errs,
            "out_err": norm_err(o[0], po[0])})
        if max(errs.values()) > TRAIN_GRAD_TOL_BF16:
            fail(f"lm_train_kernel_checks flash {[b, tq, tk, hq, hkv, d]} "
                 f"{mask}: gradients off the plain autograd by {errs} of "
                 f"their max (tolerance {TRAIN_GRAD_TOL_BF16})")
        del q, k, v, do, o, gk, po, gp
    # the backward at qwen3's training call: time, bound, the plain
    # autograd's time and SDPA's backward (kv heads repeated) as yardsticks
    q = torch.randn((B, T, Hq, hd), generator=gen).bfloat16().cuda()
    k, v = (torch.randn((B, T, Hkv, hd), generator=gen).bfloat16().cuda()
            for _ in range(2))
    do = torch.randn((B, T, Hq, hd), generator=gen).bfloat16().cuda()
    pairs = B * Hq * T * (T + 1) // 2
    # per kept (q, k) pair: s = q.k again, dp = do.v, dq += ds.k,
    # dk += ds.q, dv += p.do: 5 products of 2 hd flops (2.5x the forward)
    bnd, by = bound_ms(2 * (2 * B * T * Hq * hd + 2 * B * T * Hkv * hd) * 2,
                       10 * hd * pairs, bf16=True)
    xs = [x.float().requires_grad_() for x in (q, k, v)]
    po = ref.flash_attention_gqa_ref(*xs)
    g = Hq // Hkv
    st = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
    st = [st[0]] + [x.repeat_interleave(g, dim=1) for x in st[1:]]
    st = [x.requires_grad_() for x in st]
    so = F.scaled_dot_product_attention(*st, is_causal=True)
    sdo = do.transpose(1, 2).contiguous()
    rec["flash_backward"] = {
        "shape": [B, T, Hq, Hkv, hd], "dtype": "bfloat16",
        "ms": time_ms(lambda: fa.flash_attention_backward(q, k, v, do), n=5),
        "bound_ms": bnd, "bound_by": by,
        "bound_ms_fp32_cuda_cores": bound_ms(0, 10 * hd * pairs)[0],
        "plain_autograd_ms": time_ms(lambda: torch.autograd.grad(
            po, xs, do.float(), retain_graph=True), n=5),
        "library_ms": time_ms(lambda: torch.autograd.grad(
            so, st, sdo, retain_graph=True), n=5),
        "library_call": "autograd backward of scaled_dot_product_attention "
                        "(is_causal, kv heads repeated, bf16 P.V), a "
                        "yardstick only",
        "note": "plain PyTorch in fp32 per block of 1024 query rows, keys "
                "cut to the causal band"}
    del xs, po, st, so
    # the scan at rwkv6's training call, with upstream gradients on the
    # output and the final state
    H, hd = 40, 64
    ins = scan_inputs(gen, B, T, H, hd, "zeros", "model")
    ups = [torch.randn((B, T, H, hd), generator=gen).cuda(),
           torch.randn((B, H, hd, hd), generator=gen).cuda()]

    def plain_scan(*a):
        return ref.rwkv6_chunked_ref(*a, rs.CHUNK)
    (o, gk), (po, gp) = grads_vs_plain(rs.rwkv6_scan, plain_scan, ins, ups)
    errs = {n: norm_err(a, w) for n, a, w in zip(
        ("dr", "dk", "dv", "dlogw", "du", "dstate0"), gk, gp)}
    rec["scan_fp32"] = {"shape": [B, T, H, hd], "grad_err": errs,
                        "out_err": max(norm_err(a, w) for a, w in zip(o, po)),
                        "tolerance": f"max|a-b| <= {TRAIN_GRAD_TOL_FP32} "
                                     f"max|b|, each gradient"}
    if max(errs.values()) > TRAIN_GRAD_TOL_FP32:
        fail(f"lm_train_kernel_checks scan: gradients off the plain autograd "
             f"by {errs} (tolerance {TRAIN_GRAD_TOL_FP32})")
    c = rs.CHUNK
    per_chunk = (2 * hd * c * (c - 1) // 2 + 2 * hd * c * (c + 1) // 2
                 + 4 * c * hd * hd + hd * hd + 3 * c * hd + 7 * c * hd)
    # the forward's recompute plus two products per forward product
    bnd, by = bound_ms(9 * B * T * H * hd * 4 + 3 * B * H * hd * hd * 4
                       + 2 * H * hd * 4, 3 * per_chunk * (T // c) * B * H)
    rec["scan_backward"] = {
        "shape": [B, T, H, hd], "dtype": "float32",
        "ms": time_ms(lambda: rs.rwkv6_scan_backward(*ins, *ups), n=5),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "note": "plain PyTorch: the chunked plain version recomputed under "
                "autograd and differentiated"}
    rec["projection_lm_tables"] = [lbgm_table_check(a) for a in TRAIN_RUNS]
    emit(rec)
    return rec


@contextlib.contextmanager
def backward_timer():
    """CUDA events around every call of the two Functions' backwards:
    yields a dict whose "ms" (per Function) the caller reads after a
    synchronise."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as rs
    import torch
    spans = {"flash_attention": [], "rwkv6_scan": []}
    saved = {}
    for name, cls in (("flash_attention", fa.FlashAttention),
                      ("rwkv6_scan", rs.RWKV6Scan)):
        real = cls.backward
        saved[cls] = real

        def timed(ctx, *grads, _real=real, _name=name):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = _real(ctx, *grads)
            e.record()
            spans[_name].append((s, e))
            return out
        cls.backward = staticmethod(timed)
    res = {"spans": spans}
    try:
        yield res
    finally:
        for cls, real in saved.items():
            cls.backward = staticmethod(real)


def backward_ms(res):
    return {k: sum(s.elapsed_time(e) for s, e in v)
            for k, v in res["spans"].items() if v}


@contextlib.contextmanager
def train_probe(profiled=None, keep_update=False, compare_update=None,
                capture=None):
    """Wrap the trainer (``train.trainer.make_train_step``, looked up at
    call time by ``launch.train.main``) for one run: per step, host ms
    around the synchronised step, launches per kernel and per call shape
    (the counters set to 0 at each step's start), and every client's sin²
    and decision (the stats of ``lbgm_client_step`` /
    ``lbgm_topk_client_step``). Step 1's aggregated update (the gradient
    handed to ``sgd_update``) is kept on the host (``keep_update``) or held
    against a kept one (``compare_update``: relative L2). ``profiled``:
    that step (from 0) is profiled (and its backwards timed) instead of
    timed alone. ``capture(step, client, grad, lbg)`` sees each client's
    inputs."""
    from repro_torch.core import lbgm as lbgm_lib
    from repro_torch.kernels import _build
    from repro_torch.train import trainer as tr
    rec = {"ms": [], "launches": [], "shapes": [], "sin2": [], "sent": [],
           "update": None, "update_rel_l2": None, "profile": None,
           "profiled": profiled}
    real_make, real_sgd = tr.make_train_step, tr.sgd_update
    names = ("lbgm_client_step", "lbgm_topk_client_step")
    real_steps = {n: getattr(lbgm_lib, n) for n in names}

    def client_step(name):
        real = real_steps[name]

        def wrapped(grad, lbg, *a, **kw):
            if capture is not None:
                capture(len(rec["sin2"]) - 1, len(rec["sin2"][-1]), grad,
                        lbg)
            out = real(grad, lbg, *a, **kw)
            rec["sin2"][-1].extend(out[2].sin2.tolist())
            rec["sent"][-1].extend(out[2].sent_scalar.tolist())
            return out
        return wrapped

    def sgd(params, grads, *a, **kw):
        if len(rec["sin2"]) == 1:
            if keep_update:
                rec["update"] = {k: v.cpu() for k, v in grads.items()}
            if compare_update is not None:
                rec["update_rel_l2"] = update_rel_l2(grads, compare_update)
        return real_sgd(params, grads, *a, **kw)

    def make(*a, **kw):
        step = real_make(*a, **kw)

        def timed(state, batch):
            rec["sin2"].append([])
            rec["sent"].append([])
            i = len(rec["sin2"]) - 1
            sync()
            _build.reset_launch_counts()
            out = []
            if i == profiled:
                with backward_timer() as bw:
                    prof = profile_device(lambda: out.append(step(state,
                                                                  batch)))
                sync()
                # the backwards' spans on the device, from their first
                # kernel's start to their last's end: idle gaps between
                # their kernels count, so the share is of the step's wall
                prof["backward_span_ms"] = backward_ms(bw)
                prof["backward_span_share_of_wall"] = sum(
                    prof["backward_span_ms"].values()) / prof["wall_ms"]
                rec["profile"] = prof
                rec["ms"].append(prof["wall_ms"])
            else:
                t0 = time.perf_counter()
                out.append(step(state, batch))
                sync()
                rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["launches"].append({k: v for k, v in _build.LAUNCHES.items()
                                    if v})
            rec["shapes"].append({k: dict(v) for k, v in
                                  _build.LAUNCH_SHAPES.items() if v})
            return out[0]
        return timed

    tr.make_train_step, tr.sgd_update = make, sgd
    for n in names:
        setattr(lbgm_lib, n, client_step(n))
    try:
        yield rec
    finally:
        tr.make_train_step, tr.sgd_update = real_make, real_sgd
        for n, f in real_steps.items():
            setattr(lbgm_lib, n, f)


def train_launches(cfg, K):
    """Launches of one training step of K clients: flash or the scan per
    attention or rwkv6 call of ``lm_launches``, twice under remat (the
    forward, and the block's recompute in the backward), per client; the
    projection once per client (dense store) or the decision once per leaf
    per client (top-k store)."""
    import torch
    from repro_torch.models.transformer import init_lm
    want = {k: (2 if cfg.remat else 1) * n * K
            for k, n in lm_launches(cfg).items()}
    if cfg.lbgm.variant == "topk":
        leaves = init_lm(torch.Generator(), cfg, device="meta")[0]
        want["lbgm_sparse_decision"] = len(leaves) * K
    else:
        want["lbgm_projection"] = K
    return want


def expect_launches(what, rec, want):
    """Every step launched each kernel of ``want`` exactly so often, and
    no other kernel."""
    for i, got in enumerate(rec["launches"]):
        for k, n in want.items():
            if got.get(k, 0) != n:
                fail(f"{what}: step {i + 1} launched {got.get(k, 0)} {k}, "
                     f"want {n}")
        only_launches(f"{what}: step {i + 1}", got, want)


def keep_train_shapes(rec):
    """Fold a run's last step's launches per call shape into
    ``TRAIN_SHAPES``."""
    for k, shapes in rec["shapes"][-1].items():
        TRAIN_SHAPES.setdefault(k, {}).update(shapes)


def decisions_agree(what, a, b, delta, margin):
    """Clients whose sin² lies farther than ``margin`` from delta in both
    runs decided alike; returns the smallest margin seen."""
    least = float("inf")
    for step, (sa, sb, da, db) in enumerate(zip(a["sin2"], b["sin2"],
                                                a["sent"], b["sent"])):
        if len(sa) != len(sb):
            fail(f"{what}: step {step + 1} has {len(sa)} and {len(sb)} "
                 f"clients")
        for c, (x, y, p, q) in enumerate(zip(sa, sb, da, db)):
            m = min(abs(x - delta), abs(y - delta))
            least = min(least, m)
            if m > margin and p != q:
                fail(f"{what}: step {step + 1} client {c} decided "
                     f"{p} and {q} at sin² {x:.6g} and {y:.6g} (delta "
                     f"{delta})")
    return least


def model_flops_share(cfg, K, b, T, ms):
    """The model-FLOPs share of one training step on the card's bf16 peak
    (``analysis.roofline.model_flops`` over the step's seconds): a record,
    not a claim."""
    from repro_torch.analysis import roofline
    from repro_torch.configs.base import (ShapeConfig, active_param_count)
    shape = ShapeConfig("step", T, K * b, "train")
    flops = roofline.model_flops(cfg, shape, active_param_count(cfg))
    return {"model_flops": flops, "share_of_bf16_peak":
            flops / (ms / 1e3 * roofline.PEAK_FLOPS),
            "peak_flops": roofline.PEAK_FLOPS, "card": SMI_LINE}


def train_record(phase, arch, cfg, K, b, T, rec, history, peak_gb):
    """The end-to-end fields every training phase reports; the step times
    are those after the first, the profiled step left out."""
    steps = [{"step": i + 1, "ms": ms, "launches": launches,
              **{k: h[k] for k in ("loss", "frac_scalar", "uplink_floats",
                                   "vanilla_uplink_floats") if k in h}}
             for i, (ms, launches, h) in enumerate(zip(
                 rec["ms"], rec["launches"], history))]
    kept = [ms for i, ms in enumerate(rec["ms"]) if i != rec["profiled"]]
    timed = kept[1:] or kept
    ms = sum(timed) / len(timed)
    return {"phase": phase, "arch": arch, "dtype": cfg.dtype,
            "layers": cfg.n_layers, "dp_mode": cfg.dp_mode,
            "lbgm_variant": cfg.lbgm.variant, "clients": K, "batch": b,
            "seq_len": T, "remat": cfg.remat, "steps": steps,
            "ms_per_step": ms,
            "ms_per_step_of": (f"the mean of steps 2-{len(kept)}"
                               if len(kept) > 2 else f"step {len(kept)}"),
            "profiled_step": (None if rec["profiled"] is None
                              else rec["profiled"] + 1),
            "ms_per_step_median": median(timed),
            "tokens_per_s": K * b * T / ms * 1e3, "peak_mem_gb": peak_gb,
            "launches_per_step": rec["launches"][-1],
            "model_flops": model_flops_share(cfg, K, b, T, median(timed))}


def train_argv(arch, K, b, T, steps):
    return TRAIN_FLAGS + ["--arch", arch, "--clients", str(K), "--batch",
                          str(b), "--seq", str(T), "--steps", str(steps)]


def lm_train_main(arch, out_dir, steps, plain=False, **probe):
    """``launch.train.main`` at full width with ``TRAIN_RUNS[arch]``'s
    clients, batch and length, for ``steps`` steps: (history, probe
    record, peak GB)."""
    import torch
    from repro_torch.launch import train as launch_train
    K, b, T, _ = TRAIN_RUNS[arch]
    argv = train_argv(arch, K, b, T, steps) + ["--out", out_dir]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with train_probe(**probe) as rec:
        with (plain_lm_kernels() if plain else contextlib.nullcontext()):
            history = launch_train.main(argv)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    return history, rec, peak


def train_run(cfg, K, args, steps, params=None, plain=False, nudge=None,
              **probe):
    """``make_train_step(cfg)`` on the card for ``steps`` steps, as
    ``launch.train.main`` runs it (its batch stream and stub embeddings
    for ``args``), from ``params`` or the weights of ``--seed``, under
    :func:`train_probe` (and the plain kernels, and outputs moved by
    ``nudge`` relative, where asked): (history, probe record, peak GB).
    The allocator's cache is kept between runs of one model: a cold
    cache costs the first step seconds of allocations."""
    import torch
    from repro_torch.launch import train as launch_train
    from repro_torch.train import trainer as tr
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = None if params else torch.Generator(device="cuda").manual_seed(
        args.seed)
    state, _ = tr.init_train_state(gen, cfg, K, params=params)
    batches = launch_train.client_batches(
        args, cfg.vocab_size, "cuda",
        launch_train.stub_embeds(args, cfg, "cuda"))
    history = []
    with contextlib.ExitStack() as stack:
        if plain:
            stack.enter_context(plain_lm_kernels())
        if nudge:
            stack.enter_context(nudged_lm_kernels(nudge))
        rec = stack.enter_context(train_probe(**probe))
        step = tr.make_train_step(cfg, K, args.lr, delta=args.delta)
        for _ in range(steps):
            state, m = step(state, next(batches))
            history.append({k: float(v) for k, v in m.items()})
    del state
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    return history, rec, peak


def vs_plain(phase, history, rec, plain_run, floor_run,
             loss_rtol=TRAIN_LOSS_RTOL, update_rtol=TRAIN_UPDATE_RTOL,
             nudge=TRAIN_NUDGE, margin_of=TRAIN_MARGIN):
    """Step 1 of a kernel run against the plain kernels' run from the same
    weights: its loss within ``loss_rtol`` and its aggregated update
    within the larger of ``update_rtol`` and twice the model's own floor
    (``floor_run``: step 1 under the plain kernels with every attention
    output moved by ``nudge`` relative); decisions equal where sin² lies
    farther than ``margin_of`` from delta in both runs. The defaults are
    the bf16 runs'. ``plain_run()`` returns (history, probe record) with
    the update held against ``rec["update"]`` and kept;
    ``floor_run(plain_update)`` the floor."""
    phist, prec = plain_run()
    rec["update"] = None
    floor = floor_run(prec["update"])
    prec["update"] = None
    tol = max(update_rtol, TRAIN_UPDATE_FLOOR_FACTOR * floor)
    loss_err = abs(history[0]["loss"] - phist[0]["loss"]) / abs(
        phist[0]["loss"])
    margin = decisions_agree(f"{phase} vs plain", rec, prec, TRAIN_DELTA,
                             margin_of)
    out = {"step1_loss_rel_err": loss_err,
           "step1_update_rel_l2": prec["update_rel_l2"],
           "step1_update_floor_rel_l2": floor,
           "smallest_sin2_margin": margin,
           "plain_losses": [h["loss"] for h in phist],
           "plain_frac_scalar": [h["frac_scalar"] for h in phist],
           "plain_ms_per_step": prec["ms"],
           "tolerance": f"loss rtol {loss_rtol}; update relative L2 "
                        f"{tol:.4g} (the larger of {update_rtol} and "
                        f"{TRAIN_UPDATE_FLOOR_FACTOR} x the floor: the "
                        f"plain run against itself with attention outputs "
                        f"moved by {nudge} relative); decisions "
                        f"equal where sin² lies > {margin_of} from "
                        f"delta in both runs"}
    if loss_err > loss_rtol or prec["update_rel_l2"] > tol:
        fail(f"{phase}: step 1 off the plain kernels' run: loss "
             f"{loss_err:.3g}, update {prec['update_rel_l2']:.3g} (floor "
             f"{floor:.3g}, tolerance {tol:.3g})")
    return out


def lm_train(arch, out_dir):
    """``lm_train_<arch>``: ``launch.train.main`` at full width
    (``TRAIN_RUNS``: replicated "full", bf16, remat; the stub embeddings
    of qwen2-vl and whisper), its launches per step (``train_launches``
    and no other kernel), ms per step, tokens/s, peak memory and the
    model-FLOPs share; one more step profiled; the archs of
    ``TRAIN_VS_PLAIN`` also against 2 steps from the same weights under
    the plain kernels (``vs_plain``)."""
    import math
    import torch
    from repro_torch.launch import train as launch_train
    K, b, T, steps = TRAIN_RUNS[arch]
    args = launch_train.parse_args(train_argv(arch, K, b, T, steps))
    cfg = launch_train.train_config(args)
    held = arch in TRAIN_VS_PLAIN
    history, rec, peak = lm_train_main(arch, out_dir, steps + 1,
                                       profiled=steps, keep_update=held)
    phase = f"lm_train_{LM_PHASES[arch][0]}"
    expect_launches(phase, rec, train_launches(cfg, K))
    keep_train_shapes(rec)
    out = train_record(phase, arch, cfg, K, b, T, rec, history, peak)
    out["profile"] = rec["profile"]
    if not all(math.isfinite(h["loss"]) for h in history):
        fail(f"{phase}: non-finite loss {history}")
    if held:
        def plain_run():
            h, r, _ = lm_train_main(arch, out_dir, 2, plain=True,
                                    compare_update=rec["update"],
                                    keep_update=True)
            expect_launches(f"{phase} (plain kernels)", r, {
                k: (0 if k in LM_KERNELS else n)
                for k, n in train_launches(cfg, K).items()})
            return h, r
        out["vs_plain"] = vs_plain(
            phase, history, rec, plain_run,
            lambda upd: train_run(cfg, K, args, 1, plain=True,
                                  nudge=TRAIN_NUDGE, compare_update=upd)[1][
                "update_rel_l2"])
    out["sin2"] = rec["sin2"]
    rec["update"] = None
    torch.cuda.empty_cache()
    emit(out)
    return out


def train_block_check(p, x, cfg, kind, pos, pos3, enc_out, causal, dy):
    """One block forward and backward (upstream gradient ``dy``) through
    the kernels and through the plain kernels on the same input. Dense
    blocks: max|a-b|/max|b| of the update and of every gradient, within
    BF16_MODEL_TOL. MoE blocks (a router can flip on a float-level input
    difference): the update and the gradients in relative L2, each within
    BF16_MODEL_TOL or MOE_FLOOR_FACTOR times the floor of the plain block
    with every attention output moved by MOE_NUDGE relative. Returns (the
    kernel path's output, record)."""
    import torch
    from repro_torch.models.transformer import _apply_block_train

    def run():
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        xi = x.detach().requires_grad_()
        ins = [xi, *leaves.values()]
        eo = None
        if enc_out is not None:
            eo = enc_out.detach().requires_grad_()
            ins.append(eo)
        with moe_routes() as routes:
            y, _ = _apply_block_train(leaves, xi, cfg, kind, pos, pos3, eo,
                                      causal)
        gs = torch.autograd.grad(y, ins, dy, allow_unused=True)
        return y.detach(), [g for g in gs], routes
    yk, gk, rk = run()
    with plain_lm_kernels():
        yp, gp, rp = run()
    pairs = [(a, w) for a, w in zip(gk, gp)
             if w is not None and float(w.abs().max()) > 0]
    rec = {"kind": kind if causal else "encoder"}
    if rk:
        with plain_lm_kernels(), nudged_lm_kernels(MOE_NUDGE):
            yn, gn, rn = run()
        upd, floor = rel_l2(yk - x, yp - x), rel_l2(yn - x, yp - x)
        grad = max(rel_l2(a, w) for a, w in pairs)
        gfloor = max(rel_l2(n, w) for n, w in zip(gn, gp)
                     if w is not None and float(w.abs().max()) > 0)
        (ek, kk), (ep, kp) = rk[0], rp[0]
        rec.update(update_rel_l2=upd, floor_rel_l2=floor,
                   grad_rel_l2=grad, grad_floor_rel_l2=gfloor,
                   routes_differ=int((ek != ep).sum()),
                   drops_differ=int((kk != kp).sum()),
                   ok=(upd <= max(BF16_MODEL_TOL, MOE_FLOOR_FACTOR * floor)
                       and grad <= max(BF16_MODEL_TOL,
                                       MOE_FLOOR_FACTOR * gfloor)))
    else:
        upd = norm_err(yk.float() - x.float(), yp.float() - x.float())
        grad = max(norm_err(a, w) for a, w in pairs)
        rec.update(update_err=upd, grad_err=grad,
                   ok=max(upd, grad) <= BF16_MODEL_TOL)
    return yk, rec


def train_teacher_forced(params, cfg, tokens, extra=None):
    """The kernel path against the plain kernels', forward and backward,
    block by block on the real run's hidden states (``train_block_check``;
    the encoder's blocks too, on the stub frames): each block takes the
    same input and upstream gradient through both, and the next block
    takes the kernel path's output. Returns the blocks' records."""
    import torch
    from repro_torch.models.common import rms_norm, sinusoidal_positions
    from repro_torch.models.transformer import (build_mrope_positions,
                                                encoder_params, layer_params)
    B, T = tokens.shape
    x = params["embed"][tokens]
    pos = torch.arange(T, device=x.device)[None].expand(B, T)
    pos3 = None
    if cfg.mrope:
        pos3 = build_mrope_positions(cfg, B, T, device=x.device)
        if extra is not None:
            x = torch.cat([extra.to(x.dtype), x[:, extra.shape[1]:]], 1)
    gen = torch.Generator(device="cuda").manual_seed(12)

    def upstream(like):
        return torch.randn(like.shape, generator=gen, device="cuda").to(
            like.dtype)
    blocks, enc_out = [], None
    if cfg.encdec:
        e = extra.to(x.dtype) + sinusoidal_positions(
            extra.shape[1], cfg.d_model).to(x.device, x.dtype)
        for p in encoder_params(params, cfg):
            e, rec = train_block_check(p, e, cfg, "attn", None, None, None,
                                       False, upstream(e))
            blocks.append(rec)
        enc_out = rms_norm(e, params["enc_norm"], cfg.norm_eps)
    for kind, p in layer_params(params, cfg):
        x, rec = train_block_check(p, x, cfg, kind, pos, pos3, enc_out, True,
                                   upstream(x))
        blocks.append(rec)
    return blocks


def lm_train_layers(arch, params, cfg, args):
    """``lm_train_<arch>_layers``: every block forward and backward on
    step 1's hidden states (client 0's first batch of the run ``args``
    gives, with its stub) through the kernels and through their plain
    versions, teacher forced. This is the check that stands for rwkv6's
    kernel-vs-plain run (its 32 random-init bf16 layers are chaotic), and
    beside the end-to-end ones it holds each layer."""
    import torch
    from repro_torch.launch import train as launch_train
    batch = next(launch_train.client_batches(
        args, cfg.vocab_size, "cuda",
        launch_train.stub_embeds(args, cfg, "cuda")))
    extra = batch.get("extra")
    blocks = train_teacher_forced(params, cfg, batch["tokens"][0],
                                  None if extra is None else extra[0])
    dense = [r for r in blocks if "update_err" in r]
    rec = {"phase": f"lm_train_{LM_PHASES[arch][0]}_layers", "arch": arch,
           "layers": cfg.n_layers, "blocks": len(blocks),
           "layer_update_err_vs_plain": max(
               (r["update_err"] for r in dense), default=None),
           "grad_err_vs_plain": max((r["grad_err"] for r in dense),
                                    default=None),
           "moe_blocks": [r for r in blocks if "update_rel_l2" in r],
           "tolerance": f"max|a-b|/max|b| <= {BF16_MODEL_TOL}, every dense "
                        f"block on the same input and upstream gradient; "
                        f"MoE blocks relative L2 <= {BF16_MODEL_TOL} or "
                        f"{MOE_FLOOR_FACTOR} x the floor of a {MOE_NUDGE} "
                        f"nudge"}
    torch.cuda.synchronize()
    bad = [r for r in blocks if not r["ok"]]
    emit(rec)
    if bad:
        fail(f"lm_train {arch}: blocks off the plain kernels: {bad}")
    return rec


def plain_decision_sliced(g, idx, block, rows=8192):
    """The plain decision over a flat leaf (1, size), ``rows`` block rows
    at a time (a 1.61-billion-element leaf whole would hold ~50 GB of
    int64 sort keys): gg summed over the slices in fp32."""
    import torch
    from repro_torch.kernels import ref
    nb = idx.shape[1]
    outs = []
    for r0 in range(0, nb, rows):
        r1 = min(nb, r0 + rows)
        part = g[:, r0 * block:r1 * block]
        outs.append(ref.lbgm_sparse_decision_ref(part, idx[:, r0:r1],
                                                 block=block))
    return (sum(o[0] for o in outs),
            *(torch.cat([o[i] for o in outs], 1) for i in (1, 2, 3)))


def leaf_decision_record(g, idx, k_frac):
    """The decision on one leaf's real gradient (a flat (1, size) bf16
    leaf as the trainer passes it) against its plain version: index sets
    and values exact, ||g||² within 1e-5; its time, bound, plain time and
    ``torch.topk``'s."""
    import torch
    from repro_torch.core.lbgm import _block_layout
    from repro_torch.kernels import ops, ref
    nb, block, kb = _block_layout(g.shape[1], k_frac)
    got = ops.lbgm_sparse_decision(g, idx, two_pass=False, block=block)
    want = plain_decision_sliced(g, idx, block)
    torch.cuda.synchronize()
    exact = torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]) \
        and torch.equal(got[1], want[1])
    gg_err = float((got[0] - want[0]).abs().max() / want[0].abs().max())
    del got, want
    live = -(-g.shape[1] // block)
    bnd, by = bound_ms(g.shape[1] * g.element_size() + live * kb * 4
                       + 3 * nb * kb * 4 + 4, 2 * g.shape[1])
    padded = ref.flat_to_blocks(g, nb, block)
    return {"shape": [1, g.shape[1], nb, block, kb], "live_rows": live,
            "dtype": str(g.dtype).split(".")[-1],
            "exact_vs_plain": exact, "gg_rel_err": gg_err,
            "ms": time_ms(lambda: ops.lbgm_sparse_decision(
                g, idx, two_pass=False, block=block), n=10),
            "bound_ms": bnd, "bound_by": by,
            "plain_ms": time_ms(lambda: plain_decision_sliced(g, idx, block),
                                n=3),
            "library_ms": time_ms(lambda: torch.topk(padded.abs(), kb,
                                                     dim=-1), n=3),
            "library_call": "torch.topk of |g| per row of the layout (the "
                            "selection only)"}


def lm_train_topk(arch, params, cfg):
    """``lm_train_topk_qwen3`` / ``lm_train_mixtral`` (``TOPK_RUNS``):
    ``make_train_step`` in fsdp with the top-k store at k_frac 0.01 at
    full width (mixtral cut in depth only) from the card's seed-0
    weights: the decision kernel on every leaf of every client (the
    stacked expert leaves included) and flash per ``train_launches``, and
    no other kernel; the decision on one leaf's step-2 gradient (client
    0) held exactly against the plain version and timed; mixtral also
    held end to end against the plain kernels' run (``vs_plain``)."""
    import dataclasses
    import torch
    from repro_torch.launch import train as launch_train
    phase, _, K, b, T, steps, leaf, held = TOPK_RUNS[arch]
    k_frac = 0.01
    cfg = dataclasses.replace(cfg, dp_mode="fsdp", lbgm=dataclasses.replace(
        cfg.lbgm, variant="topk", k_frac=k_frac))
    args = launch_train.parse_args(train_argv(arch, K, b, T, steps))
    seen = {}

    def capture(step, client, grad, lbg):
        if step == 1 and client == 0:
            seen["g"] = grad[leaf].reshape(1, -1).clone()
            seen["idx"] = lbg[leaf]["idx"].clone()
    history, rec, peak = train_run(cfg, K, args, steps + 1, params=params,
                                   capture=capture, keep_update=held,
                                   profiled=steps)
    want = train_launches(cfg, K)
    expect_launches(phase, rec, want)
    keep_train_shapes(rec)
    out = train_record(phase, arch, cfg, K, b, T, rec, history, peak)
    out["profile"] = rec["profile"]
    out["sin2"] = rec["sin2"]
    if held:
        def plain_run():
            h, r, _ = train_run(cfg, K, args, steps, params=params,
                                plain=True, compare_update=rec["update"],
                                keep_update=True)
            expect_launches(f"{phase} (plain kernels)", r, {
                k: (0 if k in LM_KERNELS else n) for k, n in want.items()})
            return h, r
        out["vs_plain"] = vs_plain(
            phase, history, rec, plain_run,
            lambda upd: train_run(cfg, K, args, 1, params=params, plain=True,
                                  nudge=TRAIN_NUDGE, compare_update=upd)[1][
                "update_rel_l2"])
    rec["update"] = None
    dec = leaf_decision_record(seen.pop("g"), seen.pop("idx"), k_frac)
    out[f"{leaf.split('/')[-1]}_decision"] = dec
    if arch != "qwen3-1.7b":
        TRAIN_SHAPE_RECORDS.append(("lbgm_sparse_decision", dec))
    torch.cuda.empty_cache()
    emit(out)
    if not dec["exact_vs_plain"] or dec["gg_rel_err"] > 1e-5:
        fail(f"{phase}: the {leaf} leaf's decision differs from the plain "
             f"version (exact {dec['exact_vs_plain']}, ||g||^2 "
             f"{dec['gg_rel_err']:.3g})")
    return out


def lm_train_fp32_vs_plain(arch, K=2, b=1, T=128, steps=2):
    """``lm_train_mixtral_fp32``: ``arch`` at full width, cut in depth
    (``CARD_CPU_DEPTH``), fp32, in its config's own mode (mixtral: fsdp,
    the top-k store at k_frac 0.01), the weights drawn on the card from
    seed 0: ``make_train_step`` through the kernels (the fp32 flash kernel,
    the decision on every leaf, the stacked experts included) against the
    same steps under the plain flash, held as the card-vs-CPU phases hold
    theirs (step 1's loss within TRAIN_CPU_LOSS_RTOL, its update within
    the larger of TRAIN_CPU_UPDATE_RTOL and twice the floor of a
    FL_CPU_NUDGE nudge, decisions equal where sin² lies farther than
    TRAIN_CPU_MARGIN from delta). The tight end-to-end check of a MoE
    training step, for an arch whose CPU step does not fit the host."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    phase = f"lm_train_{LM_PHASES[arch][0]}_fp32"
    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              **CARD_CPU_DEPTH[arch])
    args = launch_train.parse_args(train_argv(arch, K, b, T, steps))
    t0 = time.perf_counter()
    history, rec, peak = train_run(cfg, K, args, steps, keep_update=True)
    want = train_launches(cfg, K)
    expect_launches(phase, rec, want)

    def plain_run():
        h, r, _ = train_run(cfg, K, args, steps, plain=True,
                            compare_update=rec["update"], keep_update=True)
        expect_launches(f"{phase} (plain kernels)", r, {
            k: (0 if k in LM_KERNELS else n) for k, n in want.items()})
        return h, r
    out = {"phase": phase, "arch": arch, "dtype": "float32",
           "layers": cfg.n_layers, "dp_mode": cfg.dp_mode,
           "lbg_variant": cfg.lbgm.variant, "k_frac": cfg.lbgm.k_frac,
           "clients": K, "batch": b, "seq_len": T, "steps": steps,
           "losses": [h["loss"] for h in history],
           "frac_scalar": [h["frac_scalar"] for h in history],
           "launches_per_step": rec["launches"][-1], "peak_gb": peak,
           "sin2": rec["sin2"],
           "reduced": [f"depth: {cfg.n_layers} of "
                       f"{get_config(arch).n_layers} layers",
                       f"T {T}, K {K}, b {b}"]}
    out["vs_plain"] = vs_plain(
        phase, history, rec, plain_run,
        lambda upd: train_run(cfg, K, args, 1, plain=True,
                              nudge=FL_CPU_NUDGE, compare_update=upd)[1][
            "update_rel_l2"],
        loss_rtol=TRAIN_CPU_LOSS_RTOL, update_rtol=TRAIN_CPU_UPDATE_RTOL,
        nudge=FL_CPU_NUDGE, margin_of=TRAIN_CPU_MARGIN)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


#: lm_train_card_vs_cpu: arch -> T, at the depths of ``CARD_CPU_DEPTH``,
#: in the configs' own mode (replicated, dense "full"), heaviest first
#: (the CPU worker takes them in this order). The zoo runs at T 128,
#: qwen2-vl at 272 (its 256 stub patches and 16 text positions). mixtral
#: is held on the card alone (``lm_train_mixtral_fp32``): its one fp32
#: layer is 11.6 GB of params, and its CPU step ran the host past its 96
#: GiB in the replicated dense mode and in its own fsdp top-k mode
TRAIN_CARD_CPU_T = {"recurrentgemma-2b": 128, "qwen2-vl-2b": 272,
                    "qwen3-1.7b": 256, "rwkv6-3b": 256, "whisper-base": 128}


def lm_train_card_vs_cpu(worker, inputs, K=2, b=1, steps=2):
    """The training archs at full width, cut in depth (``CARD_CPU_DEPTH``),
    fp32, in the configs' own mode: ``make_train_step`` on the card
    and on the CPU (``worker``'s ``train_cpu_side``) from the same params
    (drawn on the host) and batches (with the stub, drawn on the host);
    ``inputs[arch]`` is a future of ``train_cpu_inputs``, drawn beside the
    card. Step 1's loss and aggregated update, and every decision where
    sin² lies farther than 1e-5 from delta (step 2 is the first whose LBGs
    are not zero); the launches of ``train_launches`` and no other kernel;
    the host memory each process reached."""
    import torch
    from repro_torch.train import trainer as tr
    out = {}
    for arch, T in TRAIN_CARD_CPU_T.items():
        t0 = time.perf_counter()
        cfg, params, batch = inputs.pop(arch).result()
        state, _ = tr.init_train_state(None, cfg, K, device="cuda",
                                       params=params)
        del params
        on_dev = {k: v.cuda() for k, v in batch.items()}
        with train_probe(keep_update=True) as rc:
            step = tr.make_train_step(cfg, K, 0.05, delta=TRAIN_DELTA)
            lc = []
            for _ in range(steps):
                state, m = step(state, on_dev)
                lc.append(float(m["loss"]))
        del state, on_dev
        torch.cuda.empty_cache()
        card_s = time.perf_counter() - t0
        rp = worker.result(f"train-{arch}")
        lp = rp["losses"]
        upd = update_rel_l2(rp.pop("update"), rc["update"])
        rc["update"] = None
        expect_launches(f"lm_train_card_vs_cpu {arch}", rc,
                        train_launches(cfg, K))
        loss_err = abs(lc[0] - lp[0]) / abs(lp[0])
        margin = decisions_agree(f"lm_train_card_vs_cpu {arch}", rc, rp,
                                 TRAIN_DELTA, TRAIN_CPU_MARGIN)
        out[arch] = {"layers": cfg.n_layers, "seq_len": T,
                     "losses": lc, "cpu_losses": lp,
                     "step1_loss_rel_err": loss_err,
                     "step1_update_rel_l2": upd,
                     "sin2": rc["sin2"], "cpu_sin2": rp["sin2"],
                     "smallest_sin2_margin": margin,
                     "launches_per_step": rc["launches"][-1],
                     "card_s": card_s, "cpu_s": rp["seconds"],
                     "cpu_read_at_s": rp["read_at_s"],
                     "waited_for_cpu_s": rp["waited_s"],
                     "worker_peak_rss_gib": rp["peak_rss_gib"]}
        if loss_err > TRAIN_CPU_LOSS_RTOL or upd > TRAIN_CPU_UPDATE_RTOL:
            fail(f"lm_train_card_vs_cpu {arch}: step 1 loss off by "
                 f"{loss_err:.3g}, update by {upd:.3g}")
    emit({"phase": "lm_train_card_vs_cpu", "dtype": "float32",
          "clients": K, "batch": b, "steps": steps,
          "cpu_side": f"a worker process beside the card's phases "
                      f"({CPU_WORKER_THREADS} threads)",
          "tolerance": f"step 1 loss rtol {TRAIN_CPU_LOSS_RTOL}, update "
                       f"relative L2 {TRAIN_CPU_UPDATE_RTOL}, decisions "
                       f"equal where sin² lies > {TRAIN_CPU_MARGIN} from "
                       f"delta in both runs",
          "reduced": ["depth: qwen3, rwkv6 and qwen2-vl 2 layers, "
                      "recurrentgemma 3, whisper 2 + 2",
                      "T 128 (recurrentgemma, whisper), 272 (qwen2-vl); "
                      "mixtral held on the card alone "
                      "(lm_train_mixtral_fp32: host memory)"],
          "host": host_memory(),
          "archs": out})
    return out


# ----------------------------------------------------- FL rounds of the LMs

#: the full-width FL-LM spec the phases start from (qwen3-1.7b, K=4,
#: chunk 1, dense store, markov data at seq_len 2048, tau 2, b 1, lr 0.05,
#: delta 0.6, 3 rounds, seed 0); the other phases override it. Its data
#: holds one sequence per client (n = K, the iid split), so every local
#: step of a client sees the same sequence: the regime that recycles, as
#: the training phases' ``--pool 1`` (with 16 sequences a client every
#: round's gradient lay near orthogonal to the last, sin² > 0.99999, and
#: no round recycled: NVIDIA H100 80GB HBM3, 700 W)
FL_LM_SPEC = ROOT / "examples" / "specs" / "qwen3_fl_lm.json"
FL_LM_VOCAB = {"qwen3-1.7b": 151936, "rwkv6-3b": 65536,
               "mixtral-8x22b": 32768, "recurrentgemma-2b": 256000,
               "qwen2-vl-2b": 151936}
#: card against CPU in fp32 at depth 2: round 1's loss (rtol) and
#: aggregated update (relative L2: FL_CPU_UPDATE_RTOL or, where larger,
#: twice the model's own floor, the card's round against itself with the
#: LM kernel's outputs moved by FL_CPU_NUDGE relative, about 8 fp32 ulps:
#: a tau = 2 round on one sequence per client moves the model far, and
#: rwkv6's second local step then carries float-level differences of the
#: first into its gradient); the discrete fields are identical
FL_CPU_LOSS_RTOL = 1e-4
FL_CPU_UPDATE_RTOL = 1e-3
FL_CPU_NUDGE = 2.0 ** -20
#: sequences per client of the card-vs-CPU phase. On one sequence (the
#: bf16 phases' regime) rwkv6's tau = 2 round memorizes it (loss 11.64 ->
#: 2.94) and its second local step carries the first's float-level
#: differences: the card's and the CPU's round-1 updates differed by
#: 3.3e-3 relative L2 against a floor of 1.45e-3 (scan outputs moved by
#: 2^-20), round 2's losses by 1.07e-4; at depth 2 qwen3's rounds did not
#: recycle on one sequence either (NVIDIA H100 80GB HBM3, 700 W)
FL_CPU_SEQS = 8


def fl_lm_spec(arch="qwen3-1.7b", **overrides):
    """``FL_LM_SPEC`` with dotted-key overrides, at ``arch``'s vocab."""
    from repro_torch.fed.experiment import ExperimentSpec
    spec = ExperimentSpec.load(str(FL_LM_SPEC))
    return spec.with_overrides({"model.kw.arch": arch,
                                "data.kw.vocab": FL_LM_VOCAB[arch],
                                "name": f"fl-lm-{arch}", **overrides})


@contextlib.contextmanager
def fl_probe(keep_update=False, compare_update=None, profile_round=None,
             keep_engine=False):
    """Wrap the FL engine (``fed.engine.FLEngine``, looked up at run time
    by ``run_experiment``) for one run: per round, host ms around the
    synchronised round, the ms of its local SGD (``client_update``
    between two synchronisations, every chunk), launches per kernel (the
    counters set to 0 at each round's start), and every client's sin² and
    decision. Round 1's aggregated update (the ``agg`` the server steps
    by) is kept on the host (``keep_update``) or held against a kept one
    (``compare_update``: relative L2). Round ``profile_round`` runs under
    ``torch.profiler`` (kernel and copy ms, idle share); a ``topk-host``
    engine's host bank and streamed chunk bytes are recorded. With
    ``keep_engine`` the engine is kept under ``rec["engine"]`` (the caller
    copies what it needs and drops it)."""
    from repro_torch.fed import engine as fe
    from repro_torch.kernels import _build
    rec = {"ms": [], "sgd_ms": [], "launches": [], "sin2": [], "sent": [],
           "update": None, "update_rel_l2": None, "n_delivered": None,
           "n_evicted": None, "profile": None, "host_bank_gb": None,
           "chunk_device_bytes": None}
    real_round, real_run = fe.FLEngine.run_round, fe._ChunkLoop.run
    real_buffered = fe.BufferedScheduler.run_buffered
    real_make = fe.FLEngine._make_client_update

    def make(self):
        update = real_make(self)

        def timed(*a):
            sync()
            t0 = time.perf_counter()
            out = update(*a)
            sync()
            rec["sgd_ms"][-1] += (time.perf_counter() - t0) * 1e3
            return out
        return timed

    def run(self, *a, **kw):
        return keep(real_run(self, *a, **kw))

    def run_buffered(self, *a, **kw):
        return keep(real_buffered(self, *a, **kw))

    def keep(out):
        if len(rec["ms"]) == 0:
            agg = out[0]
            if keep_update:
                rec["update"] = {k: v.cpu() for k, v in agg.items()}
            if compare_update is not None:
                rec["update_rel_l2"] = update_rel_l2(agg, compare_update)
        return out

    def run_round(self, src):
        rec["sgd_ms"].append(0.0)
        sync()
        _build.reset_launch_counts()
        r = len(rec["ms"]) + 1
        m, wall, prof = timed_round(lambda: real_round(self, src),
                                    r == profile_round)
        if prof is not None:
            rec["profile"] = {"round": r, **prof}
        rec["ms"].append(wall)
        if self._host_bank:
            leaves = []
            fe._tmap(leaves.append, self.lbg)
            rec["host_bank_gb"] = sum(v.numel() * v.element_size()
                                      for v in leaves) / 1e9
            rec["chunk_device_bytes"] = self.host_chunk_device_bytes()
        rec["launches"].append({k: v for k, v in _build.LAUNCHES.items()
                                if v})
        s = self.sin2_history[-1]
        delta = self.cfg.delta_threshold
        rec["sin2"].append(s.tolist())
        rec["sent"].append([bool(x <= delta and x < 1.0) for x in s])
        rec["n_delivered"] = getattr(self, "n_delivered", None)
        rec["n_evicted"] = self.ledger.n_evicted
        if keep_engine:
            rec["engine"] = self
        return m

    fe.FLEngine.run_round, fe._ChunkLoop.run = run_round, run
    fe.BufferedScheduler.run_buffered = run_buffered
    fe.FLEngine._make_client_update = make
    try:
        yield rec
    finally:
        fe.FLEngine.run_round, fe._ChunkLoop.run = real_round, real_run
        fe.BufferedScheduler.run_buffered = real_buffered
        fe.FLEngine._make_client_update = real_make


def fl_lm_run(spec, plain=False, via_cli=None, params=None, **probe):
    """One run of ``spec`` on the card under :func:`fl_probe`: through
    ``run_experiment``, or with ``via_cli`` (the spec file's path) through
    the CLI's ``main`` (``python -m repro_torch.fed.run --spec``). Returns
    (history, final eval, probe record, peak GB)."""
    import gc
    import torch
    from repro_torch.fed import run as fed_run
    from repro_torch.fed.experiment import run_experiment
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with fl_probe(**probe) as rec:
        with (plain_lm_kernels() if plain else contextlib.nullcontext()):
            if via_cli is None:
                res = run_experiment(spec, device="cuda", params=params)
                history, final = res.history, res.final_eval
                del res
                if "engine" in rec:
                    rec["state"] = engine_state(rec.pop("engine"))
            else:
                with tempfile.TemporaryDirectory() as d:
                    out = os.path.join(d, "result.json")
                    rounds = ["--rounds", str(spec.rounds)]
                    if fed_run.main(["--spec", str(via_cli), "--out", out]
                                    + rounds) != 0:
                        fail(f"{via_cli}: the CLI exited non-zero")
                    with open(out) as f:
                        res = json.load(f)
                history = [{k: r[k] for k in ("loss", "uplink_floats",
                                              "frac_scalar", "wire_bytes",
                                              "savings")}
                           for r in res["records"]]
                final = res["final_eval"]
    gc.collect()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    return history, final, rec, peak


def fl_lm_expected(spec):
    """Launches per round of each kernel the spec's path runs: flash or
    the scan twice per call of ``lm_launches`` per local step per client
    (the forward and the block's remat recompute); the projection once per
    chunk (dense store); the decision once per leaf per chunk (top-k
    store); the dequant fold once per leaf per chunk (top-k store, lossy
    codec, the streaming "mean" fold: the collect rules decode in plain
    PyTorch)."""
    from repro_torch.fed.engine import pick_chunk
    from repro_torch.fed.experiment import MODELS
    fl = spec.fl
    leaves = len(MODELS.get("lm")(seed=0, device="meta",
                                  **spec.model.kw)[0])
    cfg = get_cfg(spec)
    chunks = -(-fl.num_clients // pick_chunk(fl.num_clients, fl.chunk_size))
    want = {k: 2 * n * fl.tau * fl.num_clients
            for k, n in lm_launches(cfg).items()}
    if fl.lbg_variant in ("topk", "topk-host", "topk-sharded"):
        want["lbgm_sparse_decision"] = leaves * chunks
        if fl.codec in ("int8", "fp8") and fl.aggregator == "mean":
            want["lbgm_dequant_accum"] = leaves * chunks
    else:
        want["lbgm_projection"] = chunks
    return want


def fl_lm_record(phase, spec, history, final, rec, peak, want, **extra):
    """The fields every FL-LM phase reports, after checking its launches
    and losses."""
    import math
    from repro_torch.fed.engine import pick_chunk
    fl = spec.fl
    for r, got in enumerate(rec["launches"]):
        for k, n in want.items():
            if got.get(k, 0) != n:
                fail(f"{phase}: round {r + 1} launched {got.get(k, 0)} {k},"
                     f" want {n}")
    losses = [h["loss"] for h in history]
    if not all(math.isfinite(x) for x in losses) or not math.isfinite(
            final.get("test_loss", 0.0)):
        fail(f"{phase}: non-finite loss {losses} {final}")
    timed = rec["ms"][1:] or rec["ms"]
    ms = sum(timed) / len(timed)
    tokens = fl.num_clients * fl.tau * fl.batch_size * \
        spec.data.kw["seq_len"]
    return {"phase": phase, "arch": spec.model.kw["arch"],
            "layers": spec.model.kw.get("n_layers", "all"),
            "dtype": spec.model.kw.get("dtype", "bfloat16"),
            "K": fl.num_clients,
            "chunk": pick_chunk(fl.num_clients, fl.chunk_size),
            "tau": fl.tau, "batch": fl.batch_size,
            "seq_len": spec.data.kw["seq_len"], "lr": fl.lr,
            "delta": fl.delta_threshold, "store": fl.lbg_variant,
            "lbg_kw": fl.lbg_kw, "codec": fl.codec,
            "rounds": len(history), "ms_per_round": ms,
            "ms_per_round_of": (f"the mean of rounds 2-{len(rec['ms'])}"
                                if len(rec["ms"]) > 2 else "round 2"),
            "round_ms": rec["ms"], "local_sgd_ms": rec["sgd_ms"],
            "tokens_per_round": tokens,
            "tokens_per_s": tokens / ms * 1e3, "peak_mem_gb": peak,
            "launches_per_round": rec["launches"],
            "expected_launches_per_round": want,
            "loss": losses, "test_loss": final.get("test_loss"),
            "frac_scalar": [h["frac_scalar"] for h in history],
            "uplink_floats": [h["uplink_floats"] for h in history],
            "wire_bytes": [h["wire_bytes"] for h in history],
            "savings": history[-1]["savings"], "sin2": rec["sin2"],
            **extra}


def fl_lm_update_floor(spec, plain_update, params=None):
    """The model's own spread of round 1's aggregated update: round 1
    under the plain kernels with every attention output moved by
    TRAIN_NUDGE relative (Gaussian), against ``plain_update``."""
    one = spec.with_overrides({"rounds": 1, "eval.final": False})
    with plain_lm_kernels(), nudged_lm_kernels(TRAIN_NUDGE):
        _, _, rec, _ = fl_lm_run(one, compare_update=plain_update,
                                 params=params)
    return rec["update_rel_l2"]


def fl_lm_profile(spec, warm=2):
    """One steady round of ``spec`` profiled on the card: ``warm`` rounds
    first, then round ``warm + 1`` under the profiler (wall ms, device
    busy ms and idle share, the kernels that took the most device
    time)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.fed.experiment import build_experiment
    engine, _ = build_experiment(spec, device="cuda")
    rng = np.random.RandomState(spec.fl.seed + 1)
    for _ in range(warm):
        engine.run_round(rng)
    prof = profile_device(lambda: engine.run_round(rng))
    prof["round"] = warm + 1
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return prof


def fl_vs_plain(phase, spec, history, rec, want, rounds, params=None):
    """The kernel run's round 1 against ``rounds`` rounds of ``spec`` under
    the plain kernels from the same weights: the plain run launches no LM
    kernel and the rest of ``want``; round 1's loss within TRAIN_LOSS_RTOL,
    its update within the larger of TRAIN_UPDATE_RTOL and twice the
    model's own floor (``fl_lm_update_floor``), decisions equal where sin²
    lies farther than TRAIN_MARGIN from delta. Returns (the record's
    ``vs_plain``, whether loss and update hold, the plain history)."""
    phist, _, prec, _ = fl_lm_run(spec.with_overrides({"rounds": rounds}),
                                  plain=True, params=params,
                                  compare_update=rec["update"],
                                  keep_update=True)
    rec["update"] = None
    for r, got in enumerate(prec["launches"]):
        for k, n in want.items():
            n = 0 if k in LM_KERNELS else n
            if got.get(k, 0) != n:
                fail(f"{phase} (plain kernels): round {r + 1} launched "
                     f"{got.get(k, 0)} {k}, want {n}")
    floor = fl_lm_update_floor(spec, prec["update"], params=params)
    prec["update"] = None
    tol = max(TRAIN_UPDATE_RTOL, TRAIN_UPDATE_FLOOR_FACTOR * floor)
    loss_err = abs(history[0]["loss"] - phist[0]["loss"]) / abs(
        phist[0]["loss"])
    margin = decisions_agree(f"{phase} vs plain", rec, prec,
                             spec.fl.delta_threshold, TRAIN_MARGIN)
    out = {
        "rounds": rounds,
        "round1_loss_rel_err": loss_err,
        "round1_update_rel_l2": prec["update_rel_l2"],
        "round1_update_floor_rel_l2": floor,
        "smallest_sin2_margin": margin,
        "plain_losses": [h["loss"] for h in phist],
        "plain_frac_scalar": [h["frac_scalar"] for h in phist],
        "plain_uplink_floats": [h["uplink_floats"] for h in phist],
        "plain_ms_per_round": prec["ms"],
        "tolerance": f"loss rtol {TRAIN_LOSS_RTOL}; update relative L2 "
                     f"{tol:.4g} (the larger of {TRAIN_UPDATE_RTOL} and "
                     f"{TRAIN_UPDATE_FLOOR_FACTOR} x the floor: the plain "
                     f"round against itself with attention outputs moved "
                     f"by {TRAIN_NUDGE} relative); decisions equal where "
                     f"sin² lies > {TRAIN_MARGIN} from delta in both runs"}
    ok = loss_err <= TRAIN_LOSS_RTOL and prec["update_rel_l2"] <= tol
    if not ok:
        out["failure"] = (f"{phase}: round 1 off the plain kernels' run: "
                          f"loss {loss_err:.3g}, update "
                          f"{prec['update_rel_l2']:.3g} (floor {floor:.3g}, "
                          f"tolerance {tol:.3g})")
    return out, ok, phist


def fl_lm_qwen3_dense():
    """``fl_lm_qwen3_dense``: the spec file as it is through the CLI's
    ``main`` on the card (K=4, chunk 1, dense store): flash 448 and the
    projection 4 launches a round; 2 rounds under the plain kernels
    (``fl_vs_plain``); then round 2 of a further run profiled."""
    spec = fl_lm_spec()
    want = fl_lm_expected(spec)
    history, final, rec, peak = fl_lm_run(spec, via_cli=FL_LM_SPEC,
                                          keep_update=True)
    out = fl_lm_record("fl_lm_qwen3_dense", spec, history, final, rec, peak,
                       want, entry="python -m repro_torch.fed.run --spec "
                       f"{os.path.relpath(FL_LM_SPEC, ROOT)} (its main)")
    out["vs_plain"], ok, _ = fl_vs_plain("fl_lm_qwen3_dense", spec, history,
                                         rec, want, 2)
    out["profile"] = fl_lm_profile(spec, warm=1)
    emit(out)
    if not ok:
        fail(out["vs_plain"]["failure"])
    return out


def engine_state(eng):
    """An engine's params and banks on the host: the banks as ``{path:
    (Kp, ...) rows in client order}`` (a sharded engine's gathered to the
    global layout first)."""
    from repro_torch.fed import engine as fe
    sync()
    params = {k: v.cpu() for k, v in eng.params.items()}
    banks = {}
    for which, bank in (("lbg", eng.lbg), ("residual", eng.residual)):
        if isinstance(eng.sched, fe.ShardedScheduler):
            bank = fe._tmap(lambda x: x.reshape((-1,) + tuple(x.shape[2:])),
                            eng.sched.global_banks(bank))
        for name, leaf in bank.items():
            for k, x in (leaf.items() if isinstance(leaf, dict)
                         else [(None, leaf)]):
                banks[f"{which}/{name}/{k}"] = x.cpu()
    return {"params": params, "banks": banks}


def fl_lm_topk(phase, arch, keep_state=False, **overrides):
    """``fl_lm_qwen3_topk_int8`` / ``fl_lm_rwkv6_topk``: the top-k store at
    k_frac 0.01 through ``run_experiment`` on the card (2 rounds). Returns
    the run's history, and with ``keep_state`` also its final params and
    banks on the host (:func:`engine_state`)."""
    spec = fl_lm_spec(arch, **{"fl.lbg_variant": "topk",
                               "fl.lbg_kw": {"k_frac": 0.01}, **overrides})
    want = fl_lm_expected(spec)
    history, final, rec, peak = fl_lm_run(spec, keep_engine=keep_state)
    out = fl_lm_record(phase, spec, history, final, rec, peak, want,
                       entry="repro_torch.fed.experiment.run_experiment")
    emit(out)
    return (history, rec["state"]) if keep_state else history


def fl_sharded_qwen3_topk(totals, inmem, state):
    """``fl_sharded_qwen3_topk``: ``fl_lm_qwen3_topk_int8``'s spec
    (full-width qwen3, K=4, chunk 2, top-k 0.01, stochastic int8, 2 rounds)
    on the ``"sharded"`` scheduler with the ``"topk-sharded"`` store, on
    the world-of-one (1, 1) mesh ``launch.mesh`` starts itself: history,
    final params and banks equal the chunked run's bit for bit."""
    spec = fl_lm_spec("qwen3-1.7b", **{
        "fl.lbg_variant": "topk-sharded", "fl.lbg_kw": {"k_frac": 0.01},
        "fl.chunk_size": 2, "fl.codec": "int8", "fl.scheduler": "sharded",
        "fl.mesh": [1, 1], "rounds": len(inmem)})
    want = fl_lm_expected(spec)
    history, final, rec, peak = fl_lm_run(spec, keep_engine=True)
    for got in rec["launches"]:
        for k, n in got.items():
            totals[k] += n
    for r, (a, b) in enumerate(zip(history, inmem)):
        for k in HIST_KEYS:
            if a[k] != b[k]:
                fail(f"fl_sharded_qwen3_topk round {r + 1}: {k} {a[k]} vs "
                     f"{b[k]} on the chunked scheduler")
    got = rec.pop("state")
    for what in ("params", "banks"):
        if got[what].keys() != state[what].keys():
            fail(f"fl_sharded_qwen3_topk: {what} {sorted(got[what])} vs "
                 f"{sorted(state[what])}")
        for k, v in got[what].items():
            if not torch_equal(v, state[what][k]):
                fail(f"fl_sharded_qwen3_topk: {what} {k} differs from the "
                     f"chunked run's")
    out = fl_lm_record("fl_sharded_qwen3_topk", spec, history, final, rec,
                       peak, want, mesh=[1, 1], bit_for_bit_chunked=True,
                       entry="repro_torch.fed.experiment.run_experiment")
    emit(out)
    return out


def torch_equal(a, b):
    """Bit for bit (a 1-byte float compared through its bits)."""
    import torch
    if a.element_size() == 1 and a.is_floating_point():
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return a.dtype == b.dtype and torch.equal(a, b)


#: fl_sharded_auto_card: the (clients, model) mesh of fl_sharded_qwen3_topk's
#: spec under model_sharding="auto" (2 gloo ranks on the one card), and the
#: depth it is cut to: at all 28 layers the phase took 193 s
#: (``scripts/chip_auto_readings.py`` on an NVIDIA H100 80GB HBM3 at
#: 700.00 W: 89.3 and 71.1 s rounds, 62-68 s of them gloo moving 45.7 GB
#: a round through the host at ~0.65 GB/s), where a phase should take ~90 s
AUTO_MESH = [1, 2]
AUTO_DEPTH = 2


def auto_engine_job(job):
    """The engine job of :func:`fl_sharded_auto_card` in a rank of
    :func:`mesh_rank`: ``build_experiment`` on the card (the params drawn
    there from the spec's seed, then cut to this rank's shards), its
    rounds through the prefetcher under :func:`collective_probe`, the
    launch counters set to 0 first; then this rank's shards against the
    ``(1, 1)`` run's final params (``job["ref_params"]``, whole leaves on
    the host): the sums of squares of their difference and of the
    reference's update from the initial shards (a replicated leaf on model
    rank 0 only), the largest difference."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.fed.experiment import ExperimentSpec, build_experiment
    from repro_torch.kernels import _build
    t_job = time.perf_counter()
    spec = ExperimentSpec.from_dict(job["spec"])
    # every local step's loss, through the client loop the build binds
    with step_losses() as steps:
        eng, _ = build_experiment(spec, device="cuda")
    tp, sched = eng._tp, eng.sched
    init = {k: v.clone() for k, v in eng._params.items()}
    elt = next(iter(init.values())).element_size()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.RandomState(spec.fl.seed + 1)
    ms, coll_ms = [], []
    with collective_probe() as coll, moe_drop_counts() as drops:
        _build.reset_launch_counts()
        src = eng.prefetcher(rng)
        try:
            for _ in range(job["rounds"]):
                sync()
                t0, c0 = time.perf_counter(), coll["ms"]
                eng.run_round(src)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                coll_ms.append(coll["ms"] - c0)
        finally:
            src.close()
        launches, shapes = _launch_shapes()
    peak = torch.cuda.max_memory_allocated()
    ref = torch.load(job["ref_params"], mmap=True)
    diff2 = upd2 = max_abs = 0.0
    for k, p in eng._params.items():
        if tp.sharded_dim(k) is None and tp.rank != 0:
            continue
        r = tp.shard(k, ref[k]).to("cuda").float()
        d = p.float() - r
        diff2 += float((d * d).sum())
        u = r - init[k].float()
        upd2 += float((u * u).sum())
        max_abs = max(max_abs, float(d.abs().max()))
    rec = {"history": eng.history,
           "sin2": [x.tolist() for x in eng.sin2_history],
           "specs": tp.specs, "model_rank": tp.rank,
           "client_rank": sched.client_rank, "local": sched.local,
           "msharded": sched._msharded, "backend": dist.get_backend(),
           "cuda_device": torch.cuda.current_device(),
           "rest_bytes": sum(v.numel() * v.element_size()
                             for v in eng._params.values()),
           "param_bytes": sum(int(np.prod(s)) * elt
                              for s in tp.shapes.values()),
           "shapes": {k: list(v) for k, v in tp.shapes.items()},
           "launches": launches, "launches_by_shape": shapes,
           "collectives": coll, "collective_ms": coll_ms, "ms": ms,
           "peak_gb": peak / 1e9, "diff2": diff2, "upd2": upd2,
           "max_abs_diff": max_abs, "moe_drops": drops,
           "step_loss": steps,
           "job_s": time.perf_counter() - t_job}
    eng.close()
    return rec


@contextlib.contextmanager
def step_losses():
    """Every local step's loss, in order (a client's tau steps, the clients
    of a chunk, the chunks, the rounds), of the engines built inside:
    ``train.trainer.grad_and_loss`` wrapped, which the engine's client
    loop binds when it is built."""
    from repro_torch.train import trainer
    out = []
    real = trainer.grad_and_loss

    def recorded(loss_fn, params, batch):
        g, loss = real(loss_fn, params, batch)
        out.append(float(loss))
        return g, loss

    trainer.grad_and_loss = recorded
    try:
        yield out
    finally:
        trainer.grad_and_loss = real


@contextlib.contextmanager
def moe_drop_counts():
    """The routes an MoE model drops past an expert's capacity, one count
    a routing of a forward (a block of a client step), in order; a
    checkpoint's recompute in the backward is not counted again."""
    import torch
    from repro_torch.models import moe as moe_lib
    drops, real = [], moe_lib.moe_routing

    def counted(p, x, cfg):
        r = real(p, x, cfg)
        if torch._C._current_graph_task_id() == -1:
            drops.append(int((~r.keep).sum()))
        return r

    moe_lib.moe_routing = counted
    try:
        yield drops
    finally:
        moe_lib.moe_routing = real


def auto_decision_records(shapes):
    """The decision at each call shape of the auto run's model ranks (the
    flat bf16 slice of a rank's rows, with ``block=``), each held against
    the plain version (indices and values exact, ||g||² within 1e-5); the
    largest call timed with its bound, plain time and torch.topk's."""
    import torch
    from repro_torch.kernels import lbgm_sparse as ks
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = []
    for i, (B, n, nb_l, block, kb) in enumerate(
            sorted(shapes, key=lambda s: -s[1])):
        g = torch.randn((B, n), generator=gen, device="cuda").bfloat16()
        idx = torch.randint(0, block, (B, nb_l, kb), generator=gen,
                            device="cuda", dtype=torch.int32)
        got = ks.lbgm_sparse_decision_batched(g, idx, block=block)
        want = plain_decision_sliced(g, idx, block)
        torch.cuda.synchronize()
        what = f"auto decision {[B, n, nb_l, block, kb]}"
        if not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
                and torch.equal(got[3], want[3])):
            fail(f"{what}: differs from the plain version")
        if not torch.allclose(got[0], want[0], rtol=1e-5, atol=0.0):
            fail(f"{what}: ||g||^2 off the plain version")
        del got, want
        rec = {"shape": [B, n, nb_l, block, kb], "dtype": "bfloat16",
               "path": "fl_sharded_auto_card (a model rank's rows)",
               "exact_vs_plain": True}
        if i == 0:
            live = -(-n // block)
            bnd, by = bound_ms(B * n * 2 + B * live * kb * 4
                               + B * nb_l * kb * 12 + B * 4, 2 * B * n)
            padded = ref.flat_to_blocks(g, nb_l, block)
            rec.update(
                ms=time_ms(lambda: ks.lbgm_sparse_decision_batched(
                    g, idx, block=block), n=10),
                bound_ms=bnd, bound_by=by,
                plain_ms=time_ms(lambda: plain_decision_sliced(
                    g, idx, block), n=3),
                library_ms=time_ms(lambda: torch.topk(
                    padded.abs(), kb, dim=-1), n=3),
                library_call="torch.topk of |g| per row of the rank's "
                             "layout (the selection only)")
            del padded
        else:
            rec["timed"] = "no: the largest call is"
        out.append(rec)
        del g, idx
        torch.cuda.empty_cache()
    return out


#: fl_sharded_auto_recurrent_card: (arch, depth, T) of the recurrent
#: families on AUTO_MESH at full width in bf16: rwkv6-3b (the scan at a
#: rank's 20 of 40 heads) and recurrentgemma-2b at one rglru, rglru, swa
#: cycle (flash at a rank's 5 query heads over the one kv head, hd 256).
#: T 512 keeps gloo's partial logits at 0.5 GB a client step for
#: recurrentgemma's 256,000-token vocabulary; there its window of 2048
#: does not bind (the CPU tests hold the windowed case)
AUTO_RECURRENT = (("rwkv6-3b", 2, 512), ("recurrentgemma-2b", 3, 512))
#: fl_sharded_auto_moe_card: the MoE family on AUTO_MESH at full width in
#: bf16, the third arm of fl_sharded_auto_recurrent_card's rank world:
#: mixtral-8x22b at 1 of 56 layers (2.91 B params, 2.42 B of them its 8
#: experts, 4 a rank; swa at a rank's 24 of 48 query heads), T 512, K 2
#: in chunks of 1
AUTO_MOE = (("mixtral-8x22b", 1, 512),)
#: fl_sharded_auto_vlm_card: the M-RoPE VLM on AUTO_MESH at full width in
#: bf16, the fourth arm of fl_sharded_auto_recurrent_card's rank world:
#: qwen2-vl-2b at 2 of 28 layers (0.56 B params, 0.47 B of them the
#: untied 151,936-token embedding and head), T 512 (a 16 x 16 vision grid
#: of 256 positions, then 256 text positions: both M-RoPE streams), K 4 in
#: chunks of 2; flash at a rank's 6 of 12 query heads over its 1 of 2 kv
#: heads. The "lm" component's batches carry no stub patches (the CPU
#: tests hold them under model_sharding="auto")
AUTO_VLM = (("qwen2-vl-2b", 2, 512),)
#: the phase an arch's record is printed under, where not its run's
AUTO_LABELS = {"mixtral-8x22b": "fl_sharded_auto_moe_card",
               "qwen2-vl-2b": "fl_sharded_auto_vlm_card"}
#: an arch's clients and chunk, where not the spec's 4 and 2: K 2 halves
#: the reshard of mixtral's 5.8 GB of params (~K x the param bytes a
#: round); chunk 1 halves a rank's whole-leaf chunk gradients (11.6 GB at
#: chunk 2: each rank held 32.8 GB when the reshard's 5.4 GB buffer ran
#: both ranks out of the card, NVIDIA H100 80GB HBM3, 700 W)
AUTO_CLIENTS = {"mixtral-8x22b": (2, 1)}


def auto_spec(arch, depth, T=None):
    """The (1, 1) spec of an auto phase, ``fl_sharded_qwen3_topk``'s at
    ``arch``, ``depth`` layers, seq_len ``T`` (None: the spec's 2048) and
    AUTO_CLIENTS' K and chunk, and the same on AUTO_MESH with
    ``model_sharding="auto"``."""
    over = {"model.kw.n_layers": depth, "fl.lbg_variant": "topk-sharded",
            "fl.lbg_kw": {"k_frac": 0.01}, "fl.chunk_size": 2,
            "fl.codec": "int8", "fl.scheduler": "sharded", "fl.mesh": [1, 1],
            "rounds": 2, "eval.final": False}
    if T is not None:
        over["data.kw.seq_len"] = T
    if arch in AUTO_CLIENTS:
        K, over["fl.chunk_size"] = AUTO_CLIENTS[arch]
        over["fl.num_clients"] = over["data.kw.n"] = K
    one = fl_lm_spec(arch, **over)
    return one, one.with_overrides({"fl.mesh": AUTO_MESH,
                                    "fl.model_sharding": "auto"})


def auto_local_calls(spec):
    """The LM kernel calls each model rank of AUTO_MESH makes: ``{kernel:
    {launch shape: call kwargs}}``, from the ranks' heads
    (``models.transformer._attn_heads``, ``models.rwkv6.tp_heads``) at B 1
    and the spec's T."""
    from repro_torch.models import rwkv6 as rw
    from repro_torch.models import transformer as tr
    cfg = get_cfg(spec)
    T, m = spec.data.kw["seq_len"], AUTO_MESH[1]
    hd = cfg.resolved_head_dim
    kinds = {cfg.block_kind(i) for i in range(cfg.n_layers)}
    out = {}
    for r in range(m):
        for kind in sorted(kinds & {"attn", "swa"}):
            _, (h_lo, h_hi), (kv_lo, kv_hi) = tr._attn_heads(cfg, m, r)
            nh, nkh = h_hi - h_lo, kv_hi - kv_lo
            g = cfg.n_heads // cfg.n_kv_heads
            if nkh > 1 and (h_lo % g or nh % g):
                nkh = nh
            window = cfg.sliding_window if kind == "swa" else None
            out.setdefault("flash_attention", {})[
                (1, T, T, nh, nkh, hd)] = {"window": window}
        if "rwkv6" in kinds:
            _, (h_lo, h_hi) = rw.tp_heads(cfg, m, r)
            out.setdefault("rwkv6_scan", {})[(1, T, h_hi - h_lo, hd)] = {}
    return out


def fl_sharded_auto_card(totals, tmp):
    """:func:`fl_sharded_auto_start` then :func:`fl_sharded_auto_finish`,
    with nothing beside the ranks."""
    return fl_sharded_auto_finish(totals, fl_sharded_auto_start(tmp))


def fl_sharded_auto_start(tmp, runs=(("qwen3-1.7b", AUTO_DEPTH, None),),
                          label="fl_sharded_auto_card"):
    """The first half of an auto phase: :func:`auto_refs` of ``runs``,
    then :func:`auto_launch`."""
    return auto_launch(tmp, auto_refs(runs, tmp), label)


def auto_refs(runs, tmp):
    """For each ``(arch, depth, T)`` of ``runs`` (:func:`auto_spec`) the
    (1, 1) reference run and the floor run in this process, the reference
    params saved under ``tmp`` for the ranks. Returns the arms of
    :func:`auto_launch`."""
    import gc
    import torch
    t0 = time.perf_counter()
    arms = []
    for arch, depth, T in runs:
        one, spec = auto_spec(arch, depth, T)
        with moe_drop_counts() as drops11, step_losses() as steps11:
            inmem, _, ref_rec, peak11 = fl_lm_run(one, keep_engine=True)
        state = ref_rec.pop("state")
        ref_path = os.path.join(tmp, f"auto_ref_params_{arch}.pt")
        torch.save(state["params"], ref_path)
        with moe_drop_counts() as drops_floor:
            floor_diff2, floor_hist = auto_update_floor(one,
                                                        state["params"])
        del state
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        arms.append({"arch": arch, "label": AUTO_LABELS.get(arch),
                     "depth": depth, "spec": spec,
                     "inmem": inmem, "ref_ms": ref_rec["ms"],
                     "peak11": peak11, "floor_diff2": floor_diff2,
                     "floor_loss": [h["loss"] for h in floor_hist],
                     "drops11": drops11, "drops_floor": drops_floor,
                     "steps11": steps11,
                     "calls": auto_local_calls(spec), "ref_path": ref_path,
                     "refs_s": time.perf_counter() - t0})
    return arms


def auto_launch(tmp, arms, label):
    """The 2 ranks of an auto phase started (:func:`start_mesh`), one
    engine job per arm of :func:`auto_refs` in order; returns what
    :func:`fl_sharded_auto_finish` needs. This process may run other
    phases while the ranks run."""
    jobs = [{"tag": arm["arch"], "auto": True, "spec": arm["spec"].to_dict(),
             "ref_params": arm["ref_path"], "rounds": len(arm["inmem"])}
            for arm in arms]
    c, m = AUTO_MESH
    worlds = [(c * m, jobs)]
    return {"label": label, "arms": arms, "tmp": tmp, "worlds": worlds,
            "refs_s": arms[-1]["refs_s"], "t0": time.perf_counter(),
            "procs": start_mesh(worlds, tmp)}


def fl_sharded_auto_finish(totals, run, beside=None):
    """An auto phase (``run``: :func:`fl_sharded_auto_start`'s; ``beside``
    names the phases this process ran while the ranks ran).
    ``fl_sharded_auto_card``: ``fl_sharded_qwen3_topk``'s spec (qwen3-1.7b
    at full width in bf16, K=4, chunk 2, tau 2, T 2048, top-k-sharded at
    k_frac 0.01, stochastic int8, 2 rounds), cut to AUTO_DEPTH layers;
    ``fl_sharded_auto_recurrent_card``: the same spec for each arch of
    AUTO_RECURRENT at its depth and T. Each runs on the (1, 2) mesh with
    ``model_sharding="auto"``: 2 gloo ranks spawned on the one card as
    ``torchrun`` spawns them, each resting its half of the params and
    running the client forward and backward tensor-parallel;
    ``fl_sharded_auto_moe_card``: the same for each arch of AUTO_MOE, at
    AUTO_CLIENTS' K and chunk, the third arm of the recurrent phase's
    ranks, with each rank's MoE drops a routing recorded (equal on every
    rank); ``fl_sharded_auto_vlm_card``: the same for each arch of
    AUTO_VLM (M-RoPE at a rank's local heads), the fourth arm. Each arch
    is held against the same spec's run on the (1, 1) mesh in this
    process: the decisions (uplink_floats, frac_scalar,
    savings) equal, loss within TRAIN_LOSS_RTOL (an MoE: every client's
    first local step within it, the round losses within twice the floor
    run's: a route flipped by float-level noise moves the later steps),
    the final params' difference, relative L2 over the
    model against the (1, 1) run's update, within the larger of
    TRAIN_UPDATE_RTOL and TRAIN_UPDATE_FLOOR_FACTOR times the model's own
    floor (the (1, 1) run again with every flash and scan output moved by
    TRAIN_NUDGE relative, :func:`auto_update_floor`: top-k at k_frac 0.01
    and stochastic int8 move with the gradients' last bits), each rank's
    resting params at most 1/2 + 0.02 of the bytes; the decision launched
    at each rank's rows, flash and the scan at each rank's local heads
    (:func:`auto_local_calls`), each held against its plain version at
    those shapes. Records ms a round, all_reduce and broadcast calls and
    bytes a round, each rank's peak; each arch's record is printed before
    a failed check exits. Returns the kernels line's new records: ``{kernel
    name: [shape records]}`` and the largest errors."""
    got = join_mesh(run["worlds"], run["tmp"], run["procs"])
    wall = time.perf_counter() - run["t0"]
    out, errs, bad = {}, {}, []
    for arm in run["arms"]:
        recs, fails = auto_arm(totals, run, arm, got[arm["arch"]], wall,
                               beside)
        for name, rs in recs.items():
            out.setdefault(name, []).extend(rs)
            for rec in rs:
                if "max_abs_err_vs_plain" in rec:
                    errs[name] = max(errs.get(name, 0.0),
                                     rec["max_abs_err_vs_plain"])
        bad += [f"{arm['arch']}: {b}" for b in fails]
    if bad:
        fail(f"{run['label']}: " + "; ".join(bad))
    return out, errs


def auto_arm(totals, run, arm, recs, wall, beside):
    """One arch of :func:`fl_sharded_auto_finish`: its checks and record.
    Returns (``{kernel name: [shape records]}``, the failed checks)."""
    import math
    import types
    import torch
    from repro_torch.configs import get_config
    spec, inmem, arch = arm["spec"], arm["inmem"], arm["arch"]
    floor_diff2, peak11 = arm["floor_diff2"], arm["peak11"]
    rounds = len(inmem)
    c, m = AUTO_MESH
    r0 = recs[0]
    label = arm["label"] or run["label"]
    bad = []
    for r, rec in enumerate(recs):
        if rec["backend"] != "gloo" or rec["cuda_device"] != 0:
            fail(f"{label} {arch}: rank {r} on {rec['backend']} card "
                 f"{rec['cuda_device']}, not gloo on card 0")
        if rec["history"] != r0["history"]:
            fail(f"{label} {arch}: rank {r} holds another history than "
                 f"rank 0")
        if rec["rest_bytes"] > (1 / m + 0.02) * rec["param_bytes"]:
            bad.append(f"rank {r} rests {rec['rest_bytes']} of "
                       f"{rec['param_bytes']} param bytes")
    if r0["specs"]["embed"] != (None, "model") or \
            r0["specs"]["lm_head"] != ("model", None):
        bad.append(f"embed {r0['specs']['embed']}, lm_head "
                   f"{r0['specs']['lm_head']}")
    loss_err = 0.0
    for r, (a, b) in enumerate(zip(inmem, r0["history"])):
        for k in ("uplink_floats", "frac_scalar", "savings"):
            if a[k] != b[k]:
                bad.append(f"round {r + 1}: {k} {b[k]} vs {a[k]} on the "
                           f"(1, 1) mesh")
        loss_err = max(loss_err, abs(a["loss"] - b["loss"]) / abs(a["loss"]))
    loss_floor = max(abs(a["loss"] - f) / abs(a["loss"])
                     for a, f in zip(inmem, arm["floor_loss"]))
    moe = get_cfg(spec).moe.num_experts > 0
    # every client's first local step: the same params and batch in both
    # runs, so only the forward's float-level noise parts them
    tau, K = spec.fl.tau, spec.fl.num_clients
    first = [abs(r0["step_loss"][i * tau] - arm["steps11"][i * tau])
             / abs(arm["steps11"][i * tau]) for i in range(K)]
    # an MoE routes each token by a discrete top-k with capacity drops: a
    # route flipped by float-level noise moves every later local step, as
    # far in the (1, 1) run against itself (the floor run); its round
    # losses are held at twice that floor, its first steps at the rtol
    loss_tol = (max(TRAIN_LOSS_RTOL, TRAIN_UPDATE_FLOOR_FACTOR * loss_floor)
                if moe else TRAIN_LOSS_RTOL)
    if not loss_err <= loss_tol:
        bad.append(f"loss {loss_err:.3g} off the (1, 1) run's (tolerance "
                   f"{loss_tol:.3g}; the floor run's {loss_floor:.3g})")
    if not max(first) <= TRAIN_LOSS_RTOL:
        bad.append(f"first local steps' loss {max(first):.3g} off the "
                   f"(1, 1) run's")
    upd = math.sqrt(sum(rec["upd2"] for rec in recs))
    upd_rel = math.sqrt(sum(rec["diff2"] for rec in recs)) / max(upd, 1e-30)
    floor = math.sqrt(floor_diff2) / max(upd, 1e-30)
    upd_tol = max(TRAIN_UPDATE_RTOL, TRAIN_UPDATE_FLOOR_FACTOR * floor)
    if not upd_rel <= upd_tol:
        bad.append(f"final params off the (1, 1) run's by {upd_rel:.3g} of "
                   f"its update (tolerance {upd_tol:.3g}, floor {floor:.3g})")
    if any(rec["moe_drops"] != r0["moe_drops"] for rec in recs):
        bad.append("the ranks dropped other routes: "
                   f"{[rec['moe_drops'] for rec in recs]}")
    if moe and len(r0["moe_drops"]) != (
            arm["depth"] * spec.fl.num_clients * spec.fl.tau * rounds):
        bad.append(f"{len(r0['moe_drops'])} MoE routings, not one a block "
                   f"a client step")
    delta = spec.fl.delta_threshold
    margin = min(abs(x - delta) for rnd in r0["sin2"] for x in rnd)
    like = {k: types.SimpleNamespace(size=int(math.prod(v)))
            for k, v in r0["shapes"].items()}
    rows = rank_row_launches(f"{label} {arch}", AUTO_MESH, recs, like, 0.01,
                             "cuda")
    shapes = {}
    for rec in recs:
        for k, n in rec["launches"].items():
            totals[k] += n
        for k, v in rec["launches_by_shape"].items():
            for shp, n in v.items():
                SHAPE_TOTALS.setdefault(k, {})
                SHAPE_TOTALS[k][shp] = SHAPE_TOTALS[k].get(shp, 0) + n
                shapes.setdefault(k, {})
                shapes[k][shp] = shapes[k].get(shp, 0) + n
    gen = torch.Generator().manual_seed(12)
    kern = {}
    for name, calls in sorted(arm["calls"].items()):
        for shp, kw in sorted(calls.items()):
            if not shapes.get(name, {}).get(shp):
                bad.append(f"{name} never launched at the local heads "
                           f"{shp}: {shapes.get(name)}")
            if name == "flash_attention":
                err = check_flash(gen, *shp, torch.bfloat16, True,
                                  kw["window"])
                rec = dict(flash_shape_record(gen, *shp, window=kw[
                    "window"]), path=f"{label} {arch}",
                    max_abs_err_vs_plain=err)
            else:
                rec = dict(scan_shape_record(gen, *shp),
                           path=f"{label} {arch}")
            kern.setdefault(name, []).append(rec)
    kern["lbgm_sparse_decision"] = [
        dict(rec, path=f"{label} {arch} (a model rank's rows)")
        for rec in auto_decision_records(
            list(shapes.get("lbgm_sparse_decision", {})))]
    coll = [rec["collectives"] for rec in recs]
    emit({"phase": label, "mesh": AUTO_MESH, "ranks": c * m,
          "model_sharding": "auto", "arch": arch,
          "dtype": "bfloat16", "K": spec.fl.num_clients,
          "chunk": spec.fl.chunk_size, "tau": spec.fl.tau,
          "seq_len": spec.data.kw["seq_len"], "codec": spec.fl.codec,
          "k_frac": 0.01, "rounds": rounds,
          "backend": "gloo (CUDA tensors), both ranks on card 0",
          "process_group": "started by the engine's mesh from the "
                           "launcher's environment (env://)",
          "specs": r0["specs"],
          "rest_bytes_per_rank": [rec["rest_bytes"] for rec in recs],
          "param_bytes": r0["param_bytes"],
          "rest_share_per_rank": [rec["rest_bytes"] / rec["param_bytes"]
                                  for rec in recs],
          "peak_gb_per_rank": [rec["peak_gb"] for rec in recs],
          "peak_gb_of": "torch.cuda.max_memory_allocated in each rank's "
                        "process over its rounds",
          "layers": arm["depth"],
          "reduced": [f"depth: {arm['depth']} of {arch}'s "
                      f"{get_config(arch).n_layers} layers (the (1, 1) "
                      f"reference run at the same depth)"]
          + ([f"seq_len {spec.data.kw['seq_len']} (the FL-LM phases' "
              f"2048)"] if spec.data.kw["seq_len"] != 2048 else [])
          + ([f"K {spec.fl.num_clients} (the spec's 4): half the "
              f"reshard; chunk {spec.fl.chunk_size} (2): half a rank's "
              f"whole-leaf chunk gradients"] if arch in AUTO_CLIENTS
             else []),
          "peak_gb_1x1": peak11,
          "ms_per_round_rank0": r0["ms"],
          "ms_per_round_of": "each round under the collective probe (two "
                             "card synchronisations around each "
                             "collective); both ranks share the card and "
                             "the host's cores with this process's "
                             "phases (ranks_ran_beside) and the CPU "
                             "worker",
          "ms_per_round_1x1": arm["ref_ms"],
          "ranks_ran_beside": beside,
          "collective_calls_per_round": [x["calls"] / rounds for x in coll],
          "collective_bytes_per_round": [x["bytes"] / rounds for x in coll],
          "collective_ms_by_round": [rec["collective_ms"] for rec in recs],
          "broadcasts_per_round": [
              {k: v / rounds for k, v in x["broadcast"].items()}
              for x in coll],
          "collectives_of": "all_reduce and broadcast calls (the "
                            "reshards), bytes of the tensor passed, each "
                            "timed between two synchronisations",
          "job_s_per_rank": [rec["job_s"] for rec in recs],
          "wall_s": wall, "refs_s": run["refs_s"],
          "wall_of": "wall_s: from the ranks' start to their join, every "
                     "arch's job; refs_s: every arch's (1, 1) reference "
                     "and floor runs in this process before",
          "loss": [h["loss"] for h in r0["history"]],
          "loss_1x1": [h["loss"] for h in inmem],
          "loss_max_rel_err": loss_err,
          "loss_floor": arm["floor_loss"],
          "loss_floor_max_rel_err": loss_floor,
          "loss_tolerance": loss_tol,
          "first_step_loss": [r0["step_loss"][i * tau] for i in range(K)],
          "first_step_loss_1x1": [arm["steps11"][i * tau]
                                  for i in range(K)],
          "first_step_loss_max_rel_err": max(first),
          "wire_bytes": [h["wire_bytes"] for h in r0["history"]],
          "wire_bytes_1x1": [h["wire_bytes"] for h in inmem],
          "params_rel_l2_of_update": upd_rel,
          "params_floor_rel_l2_of_update": floor,
          "params_max_abs_diff": max(rec["max_abs_diff"] for rec in recs),
          "smallest_sin2_margin": margin,
          **({"moe_drops_per_block": [rec["moe_drops"] for rec in recs],
              "moe_drops_per_block_1x1": arm["drops11"],
              "moe_drops_per_block_floor": arm["drops_floor"],
              "moe_drops_of": "routes past an expert's capacity of each "
                              "MoE routing of a forward (a block of a "
                              "client step, in order) on each rank, the "
                              "(1, 1) run and the floor run; the ranks "
                              "must agree exactly"} if moe else {}),
          "tolerance": f"uplink_floats, frac_scalar, savings equal; loss "
                       f"rtol {loss_tol:.4g}"
                       + (f" (an MoE: twice the floor run's, each "
                          f"client's first local step at rtol "
                          f"{TRAIN_LOSS_RTOL})" if moe else "")
                       + f"; final params within "
                       f"{upd_tol:.4g} of the (1, 1) run's update "
                       f"(relative L2 over the model; the larger of "
                       f"{TRAIN_UPDATE_RTOL} and "
                       f"{TRAIN_UPDATE_FLOOR_FACTOR} x the floor: the "
                       f"(1, 1) run against itself with flash and scan "
                       f"outputs moved by {TRAIN_NUDGE} relative)",
          "failures": bad,
          "decision_launches_at_rank_rows": rows,
          "launches_per_rank": [rec["launches"] for rec in recs],
          "local_kernels": kern,
          "nvidia_smi": SMI_LINE})
    return kern, bad


def scan_bound(B, T, H, hd):
    """(bound ms, bound by) of one scan call at (B, T, H, hd) from a zero
    state: per chunk and head the strictly-lower c x c product, A.v with
    the diagonal, r_dec.S, the state update and decay, the diagonal bonus,
    and 7 elementwise ops per element (cum, 3 exps, 3 products); fp32 work
    at the fp32 rate (the kernel runs the products as three TF32
    tensor-core products each: hi.hi, hi.lo, lo.hi); r, k, v, log decay
    read and out written once, the state written, u read."""
    from repro_torch.kernels import rwkv6_scan as rs
    c = min(rs.CHUNK, T)
    per_chunk = (2 * hd * c * (c - 1) // 2 + 2 * hd * c * (c + 1) // 2
                 + 4 * c * hd * hd + hd * hd + 3 * c * hd + 7 * c * hd)
    flops = per_chunk * (T // c) * B * H
    nbytes = 5 * B * T * H * hd * 4 + 2 * B * H * hd * hd * 4 + H * hd * 4
    return bound_ms(nbytes, flops)


def scan_shape_record(gen, B, T, H, hd):
    """The scan kernel at one call shape of the main path (fp32, a zero
    state, the LM's decay), held against its plain chunked version
    (:func:`check_scan`): ms, bound, the plain version's ms. ``launches``
    is filled in from the main path's per-shape counts."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rs
    err, _ = check_scan(gen, B, T, H, hd, "zeros", "model")
    ins = scan_inputs(gen, B, T, H, hd, "zeros", "model")
    bnd, by = scan_bound(B, T, H, hd)
    return {"shape": [B, T, H, hd], "dtype": "float32", "launches": None,
            "ms": time_ms(lambda: rs.rwkv6_scan(*ins)),
            "plain_ms": time_ms(lambda: ref.rwkv6_chunked_ref(
                *ins, min(rs.CHUNK, T)), n=5),
            "bound_ms": bnd, "bound_by": by, "library_ms": None,
            "library_call": "none: no single PyTorch call computes the "
                            "chunked WKV recurrence",
            "max_abs_err_vs_plain": err}


def auto_update_floor(one, ref_params):
    """The sum of squares, over the model, of the (1, 1) run's final
    params moved by float-level noise: ``one`` (the (1, 1) spec) with
    every flash and scan output moved by TRAIN_NUDGE relative
    (:func:`nudged_lm_kernels`), its final params against
    ``ref_params`` (the (1, 1) run's, on the host); and the nudged run's
    history."""
    import torch
    with nudged_lm_kernels(TRAIN_NUDGE):
        history, _, rec, _ = fl_lm_run(one, keep_engine=True)
    params = rec.pop("state")["params"]
    total = 0.0
    for k, v in params.items():
        d = v.cuda().float() - ref_params[k].cuda().float()
        total += float((d * d).sum())
    return total, history


def fl_lm_mixtral_topk(params, depth, rounds=3):
    """``fl_lm_mixtral_topk``: mixtral-8x22b cut in depth only, with the
    weights of ``lm_train_mixtral`` (``params``, on the card), through
    ``run_experiment``: the ``"lm"`` component's client loop, K=2, chunk 1,
    tau 2, b 1, T 2048, the top-k store at k_frac 0.01, ``rounds`` rounds,
    the last profiled: flash and the decision (every leaf, the stacked
    experts included) per ``fl_lm_expected`` and no other kernel; 2
    rounds under the plain kernels, held as ``fl_lm_qwen3_dense`` holds
    its run (round 1's
    loss within TRAIN_LOSS_RTOL, its update within the larger of
    TRAIN_UPDATE_RTOL and twice the model's own floor, decisions equal
    where sin² lies farther than TRAIN_MARGIN from delta)."""
    phase = "fl_lm_mixtral_topk"
    spec = fl_lm_spec("mixtral-8x22b", **{
        "model.kw.n_layers": depth, "fl.num_clients": 2, "data.kw.n": 2,
        "fl.lbg_variant": "topk", "fl.lbg_kw": {"k_frac": 0.01},
        "rounds": rounds})
    want = fl_lm_expected(spec)
    history, final, rec, peak = fl_lm_run(spec, params=params,
                                          keep_update=True,
                                          profile_round=rounds)
    for r, got in enumerate(rec["launches"]):
        only_launches(f"{phase}: round {r + 1}", got, want)
    timed = rec["ms"][1:rounds - 1]
    out = fl_lm_record(phase, spec, history, final, rec, peak, want,
                       entry="repro_torch.fed.experiment.run_experiment",
                       ms_per_round=median(timed),
                       ms_per_round_of=f"rounds 2-{rounds - 1} (round "
                                       f"{rounds} profiled)",
                       profile=rec["profile"],
                       reduced=[f"depth: {depth} of 56 layers"],
                       model_flops=model_flops_share(
                           get_cfg(spec), spec.fl.num_clients * spec.fl.tau,
                           spec.fl.batch_size, spec.data.kw["seq_len"],
                           median(timed)))
    out["vs_plain"], ok, _ = fl_vs_plain(phase, spec, history, rec, want, 2,
                                         params=params)
    emit(out)
    if not ok:
        fail(out["vs_plain"]["failure"])
    return out


def get_cfg(spec):
    """The arch config of an ``"lm"`` spec (its depth cut applied)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(spec.model.kw["arch"])
    n = spec.model.kw.get("n_layers")
    return dataclasses.replace(cfg, n_layers=n) if n else cfg


def fl_lm_qwen3_buffered_scalar_median(plain_rounds=2):
    """``fl_lm_qwen3_buffered_scalar_median``: full-width qwen3 (card-drawn
    bf16 weights, remat, one markov sequence a client) through
    ``run_experiment``: K=4, chunk 2, tau 2, b 1, T 2048, top-k 0.01 with
    the int8 wire, the buffered scheduler with one straggler a round late,
    ``scalar_median`` against one ``sign_flip`` client (scale 4), 3 rounds:
    flash 448 and the decision 28 launches a round (the collect rule
    decodes the int8 payloads in plain PyTorch: no dequant fold). Then
    ``plain_rounds`` rounds under the plain kernels, held as
    ``fl_lm_qwen3_dense`` holds its run (round 1's loss within
    TRAIN_LOSS_RTOL, its update within the larger of TRAIN_UPDATE_RTOL and
    twice the model's own floor, decisions equal where sin² lies farther
    than TRAIN_MARGIN from delta)."""
    phase = "fl_lm_qwen3_buffered_scalar_median"
    spec = fl_lm_spec(**{
        "fl.num_clients": 4, "fl.chunk_size": 2, "fl.lbg_variant": "topk",
        "fl.lbg_kw": {"k_frac": 0.01}, "fl.codec": "int8",
        "fl.scheduler": "buffered", "fl.latency": "straggler",
        "fl.latency_kw": {"frac": 0.25, "delay": 1},
        "fl.aggregator": "scalar_median", "fl.attack": "sign_flip",
        "fl.attack_frac": 0.25, "fl.attack_kw": {"scale": 4.0},
        "rounds": 3})
    want = fl_lm_expected(spec)
    history, final, rec, peak = fl_lm_run(spec, keep_update=True)
    out = fl_lm_record(phase, spec, history, final, rec, peak, want,
                       entry="repro_torch.fed.experiment.run_experiment",
                       ms_per_round_of="the mean of rounds 2-3",
                       scheduler="buffered", latency=spec.fl.latency_kw,
                       aggregator=spec.fl.aggregator,
                       attack=[spec.fl.attack, spec.fl.attack_frac,
                               spec.fl.attack_kw],
                       n_delivered=rec["n_delivered"],
                       n_evicted=rec["n_evicted"])
    out["vs_plain"], ok, phist = fl_vs_plain(phase, spec, history, rec,
                                             want, plain_rounds)
    for r, (a, b) in enumerate(zip(history, phist)):
        if a["uplink_floats"] != b["uplink_floats"] and \
                out["vs_plain"]["smallest_sin2_margin"] > TRAIN_MARGIN:
            fail(f"{phase}: round {r + 1} uplink {a['uplink_floats']} vs "
                 f"{b['uplink_floats']} under the plain kernels")
    emit(out)
    if not ok:
        fail(out["vs_plain"]["failure"])
    if not rec["n_delivered"]:
        fail(f"{phase}: no payload delivered in {spec.rounds} rounds")
    return out


def fl_lm_card_vs_cpu(worker, inputs, K=2, T=256, rounds=2):
    """Both archs at full width, depth 2, fp32: 2 rounds of K=2, b=1,
    T=256 (dense store, FL_CPU_SEQS sequences per client) on the card
    and on the CPU (``worker``'s ``fl_cpu_side``) from the same params
    (drawn on the host): ``uplink_floats``, ``frac_scalar``,
    ``wire_bytes`` and ``savings`` identical and losses within
    FL_CPU_LOSS_RTOL in every round; round 1's aggregated update within
    the larger of FL_CPU_UPDATE_RTOL and twice the model's own floor
    (``nudged_lm_kernels``), as the training phases hold step 1.
    ``inputs[arch]`` is a future of ``fl_cvc_inputs``."""
    import numpy as np
    out = {}
    for arch in LM_KERNEL:
        spec, params = inputs.pop(arch).result()
        want = fl_lm_expected(spec)
        history, _, rec, _ = fl_lm_run(spec, params=params, keep_update=True)
        with nudged_lm_kernels(FL_CPU_NUDGE):
            _, _, frec, _ = fl_lm_run(spec.with_overrides({"rounds": 1}),
                                      params=params,
                                      compare_update=rec["update"])
        del params
        floor = frec["update_rel_l2"]
        tol = max(FL_CPU_UPDATE_RTOL, TRAIN_UPDATE_FLOOR_FACTOR * floor)
        cpu = worker.result(f"fl-{arch}")
        upd = update_rel_l2(cpu.pop("update"), rec["update"])
        rec["update"] = None
        for r, (a, b) in enumerate(zip(history, cpu["history"])):
            for k in ("uplink_floats", "frac_scalar", "wire_bytes",
                      "savings"):
                if a[k] != b[k]:
                    fail(f"fl_lm_card_vs_cpu {arch} round {r + 1}: {k} "
                         f"{a[k]} on the card vs {b[k]} on the CPU")
            if not np.isfinite(a["loss"]) or abs(a["loss"] - b["loss"]) > \
                    FL_CPU_LOSS_RTOL * abs(b["loss"]):
                fail(f"fl_lm_card_vs_cpu {arch} round {r + 1}: loss "
                     f"{a['loss']} vs {b['loss']}")
        loss_err = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                    for a, b in zip(history, cpu["history"])]
        if upd > tol:
            fail(f"fl_lm_card_vs_cpu {arch}: round 1's update off by "
                 f"{upd:.3g} (floor {floor:.3g}, tolerance {tol:.3g})")
        for r, got in enumerate(rec["launches"]):
            for k, n in want.items():
                if got.get(k, 0) != n:
                    fail(f"fl_lm_card_vs_cpu {arch}: round {r + 1} launched"
                         f" {got.get(k, 0)} {k}, want {n}")
        delta = spec.fl.delta_threshold
        out[arch] = {
            "losses": [h["loss"] for h in history],
            "cpu_losses": [h["loss"] for h in cpu["history"]],
            "loss_rel_err": loss_err,
            "round1_update_rel_l2": upd,
            "round1_update_floor_rel_l2": floor,
            "round1_update_tolerance": tol,
            "frac_scalar": [h["frac_scalar"] for h in history],
            "uplink_floats": [h["uplink_floats"] for h in history],
            "wire_bytes": [h["wire_bytes"] for h in history],
            "sin2": rec["sin2"], "cpu_sin2": cpu["sin2"],
            "smallest_sin2_margin": min(
                float(np.min(np.abs(np.asarray(s) - delta)))
                for s in rec["sin2"]),
            "launches_per_round": rec["launches"],
            "ms_per_round": rec["ms"],
            "cpu_ms_per_round": cpu["ms_per_round"],
            "cpu_s": cpu["seconds"], "cpu_read_at_s": cpu["read_at_s"],
            "waited_for_cpu_s": cpu["waited_s"]}
        del cpu
    emit({"phase": "fl_lm_card_vs_cpu", "layers": 2, "dtype": "float32",
          "K": K, "batch": 1, "seq_len": T, "rounds": rounds,
          "sequences_per_client": FL_CPU_SEQS,
          "cpu_side": f"a worker process beside the card's phases "
                      f"({CPU_WORKER_THREADS} threads)",
          "tolerance": "uplink_floats, frac_scalar, wire_bytes, savings "
                       f"identical and loss rtol {FL_CPU_LOSS_RTOL} in "
                       f"every round; round 1's update relative L2 the "
                       f"larger of {FL_CPU_UPDATE_RTOL} and "
                       f"{TRAIN_UPDATE_FLOOR_FACTOR} x the floor (the card "
                       f"against itself with the LM kernel's outputs moved "
                       f"by {FL_CPU_NUDGE} relative)",
          "archs": out})
    return out


# ------------------------------------------------- one-host scale-out

HIER_SPEC = ROOT / "examples" / "specs" / "hier_100k.json"
#: the leaves of hier_100k's FCN (d_model 32), in sorted key order
HIER_LEAF_SIZES = (32, 25088, 10, 320)
#: the rounds of the shipped spec's run (5 of its 20, cut to pay for
#: fl_sharded_auto_card and fl_sharded_auto_recurrent_card);
#: the resume phase's checkpoint round and the
#: round it resumes to (that phase checkpoints every HIER_SAVE rounds)
HIER_ROUNDS, HIER_SAVE, HIER_RESUMED = 5, 2, 3
#: the rounds of the comparison runs (the shipped run is never cut)
HIER_CMP_ROUNDS = 3
#: the K = 100,000 topk-host peak may exceed the K = 10,000 peak by this
#: share of the in-memory bank: the JAX package's fixed-device-memory claim
HIER_PEAK_SHARE = 0.05
HIST_KEYS = ("loss", "uplink_floats", "frac_scalar", "wire_bytes",
             "total_uplink", "vanilla_uplink", "savings",
             "total_wire_bytes", "wire_savings")


def hier_spec(tmp, **overrides):
    """``examples/specs/hier_100k.json`` with its checkpoint moved under
    ``tmp`` and dotted-key overrides."""
    from repro_torch.fed.experiment import ExperimentSpec
    spec = ExperimentSpec.load(str(HIER_SPEC))
    return spec.with_overrides({
        "fl.ckpt_path": os.path.join(tmp, "hier_100k.ckpt.npz"),
        **overrides})


def device_split(prof):
    """``(kernel ms, copy ms, kernels, top kernels)`` of a profile: the
    copies (memcpy, memset) run beside the kernels on the streamer's side
    stream, so they are counted apart."""
    by_name, n, busy = device_events(prof)
    copies = {k: v for k, v in by_name.items()
              if k.startswith(("Memcpy", "Memset"))}
    copy_ms = sum(v[0] for v in copies.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return (busy - copy_ms, copy_ms, n - sum(v[1] for v in copies.values()),
            [{"name": k[:80], "ms": v[0] / 1e3, "count": v[1]}
             for k, v in top])


def timed_round(call, profiled=False):
    """``(result, wall ms, profile or None)`` of one synchronised round;
    with ``profiled`` under ``torch.profiler``: kernel and copy ms, the
    device's idle share (kernels against wall), the top entries."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not profiled:
        t0 = time.perf_counter()
        out = call()
        sync()
        return out, (time.perf_counter() - t0) * 1e3, None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    kern, copy, n, top = device_split(prof)
    return out, wall, {
        "wall_ms": wall, "device_kernels": n,
        "kernel_busy_ms": kern if n else "not measured",
        "copy_ms": copy if n else "not measured",
        "device_idle_share": (1 - kern / wall) if n else "not measured",
        "top": top}


@contextlib.contextmanager
def round_probe(keep_params_at=(), profile_at=None):
    """Wrap the FL engine's ``run_round`` for one run: each round's ms
    (host clock around the synchronised round), the params on the host
    after the rounds in ``keep_params_at``, each round's tier bytes, the
    host bank's and one streamed chunk's bytes, and round ``profile_at``
    under ``torch.profiler`` (wall, kernel and copy ms, idle share); and
    the ms of each round's host draws and gather (``_sample_batches``, on
    the prefetcher's thread)."""
    import torch
    from repro_torch.fed import engine as fe
    rec = {"ms": [], "rounds": [], "params": {}, "tiers": [],
           "profile": None, "host_bank_gb": None,
           "chunk_device_bytes": None, "sin2": [], "sample_ms": []}
    real = fe.FLEngine.run_round
    real_sample = fe.FLEngine._sample_batches

    def sample(self, rng):
        # on the prefetcher's thread: the host's draws and gather a round
        t0 = time.perf_counter()
        out = real_sample(self, rng)
        rec["sample_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def run_round(self, src):
        r = len(self.history) + 1
        torch.cuda.synchronize()
        m, wall, prof = timed_round(lambda: real(self, src), r == profile_at)
        if prof is not None:
            rec["profile"] = {"round": r, **prof}
        rec["ms"].append(wall)
        rec["rounds"].append(r)
        rec["tiers"].append(self.ledger.per_round[-1].get("tiers"))
        rec["sin2"].append(self.sin2_history[-1])
        if r in keep_params_at:
            rec["params"][r] = {k: v.cpu() for k, v in self.params.items()}
        if self._host_bank:
            leaves = []
            fe._tmap(leaves.append, self.lbg)
            rec["host_bank_gb"] = sum(v.numel() * v.element_size()
                                      for v in leaves) / 1e9
            rec["bank_pinned"] = all(v.is_pinned() for v in leaves)
            rec["chunk_device_bytes"] = self.host_chunk_device_bytes()
        return m

    fe.FLEngine.run_round = run_round
    fe.FLEngine._sample_batches = sample
    try:
        yield rec
    finally:
        fe.FLEngine.run_round = real
        fe.FLEngine._sample_batches = real_sample


def steady_ms(rec):
    """Mean ms a round over the rounds after the first, the profiled one
    left out."""
    prof = (rec["profile"] or {}).get("round")
    ms = [m for r, m in zip(rec["rounds"], rec["ms"])
          if r != rec["rounds"][0] and r != prof]
    return sum(ms) / max(len(ms), 1)


def count_launches(label, totals, want=None):
    """Fold the launch counters into the kernels line's totals (and its
    per-shape counts); fail where a kernel of ``want`` launched no time
    or, where ``want`` gives a count, another number of times."""
    from repro_torch.kernels import _build
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    by_shape = {k: dict(v) for k, v in _build.LAUNCH_SHAPES.items() if v}
    for k, n in (want or {}).items():
        if launches.get(k, 0) <= 0 or (n is not None
                                       and launches.get(k, 0) != n):
            fail(f"{label}: {k} launched {launches.get(k, 0)} times, "
                 f"want {n if n is not None else '> 0'}")
    for k, n in launches.items():
        totals[k] += n
    for k, shapes in by_shape.items():
        for shp, c in shapes.items():
            SHAPE_TOTALS.setdefault(k, {})
            SHAPE_TOTALS[k][shp] = SHAPE_TOTALS[k].get(shp, 0) + c
    return launches, {k: [[list(shp), c] for shp, c in v.items()]
                      for k, v in by_shape.items()}


def hier_run(label, spec, totals, **probe):
    """``run_experiment(spec)`` on the card under :func:`round_probe`,
    with the launch counters set to 0 just before and read just after.
    Returns (result, probe record, peak device bytes above those held
    before the run, launches, by shape)."""
    import gc
    import torch
    from repro_torch.fed.engine import pick_chunk
    from repro_torch.fed.experiment import run_experiment
    from repro_torch.kernels import _build
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fl = spec.fl
    chunks = -(-fl.num_clients // pick_chunk(fl.num_clients, fl.chunk_size))
    _build.reset_launch_counts()
    with round_probe(**probe) as rec:
        res = run_experiment(spec, device="cuda")
    torch.cuda.synchronize()
    # the run's own peak, above what earlier phases hold
    peak = torch.cuda.max_memory_allocated() - held
    # the decision once per leaf per chunk (the FCN's 4 leaves)
    launches, by_shape = count_launches(
        label, totals, {"lbgm_sparse_decision": 4 * chunks * spec.rounds})
    return res, rec, peak, launches, by_shape


def hier_100k_topk_host(totals, tmp):
    """``hier_100k_topk_host``: ``examples/specs/hier_100k.json`` (K =
    100,000, chunk 500, ``topk-host`` at k_frac 0.05, tiers [256, 16]
    shuffled, a checkpoint every 5 rounds, prefetch on) for HIER_ROUNDS of
    its 20 rounds, its checkpoint moved under ``tmp``: ms a round, round 4
    profiled (kernel and copy ms, idle share), the host bank, one streamed
    chunk's device bytes, the peak, the last round's tier bytes."""
    import math
    from repro_torch.fed.engine import pick_chunk
    spec = hier_spec(tmp, rounds=HIER_ROUNDS)
    t0 = time.perf_counter()
    res, rec, peak, launches, by_shape = hier_run(
        "hier_100k_topk_host", spec, totals,
        keep_params_at=(HIER_CMP_ROUNDS, HIER_RESUMED), profile_at=4)
    seconds = time.perf_counter() - t0
    hist = res.history
    if len(hist) != HIER_ROUNDS or not all(
            math.isfinite(h["loss"]) for h in hist) or not math.isfinite(
            res.final_eval.get("test_loss", float("nan"))):
        fail(f"hier_100k_topk_host: {len(hist)} rounds, losses "
             f"{[h['loss'] for h in hist]}, eval {res.final_eval}")
    if not os.path.exists(spec.fl.ckpt_path):
        fail("hier_100k_topk_host: no checkpoint written")
    if not rec["bank_pinned"]:
        fail("hier_100k_topk_host: the host bank is not pinned")
    emit({"phase": "hier_100k_topk_host", "spec": str(
              HIER_SPEC.relative_to(ROOT)),
          "K": spec.fl.num_clients,
          "chunk": pick_chunk(spec.fl.num_clients, spec.fl.chunk_size),
          "rounds": len(hist),
          "tiers": spec.fl.tiers, "ckpt_every": spec.fl.ckpt_every,
          "seconds": seconds, "ms_per_round": steady_ms(rec),
          "ms_per_round_of": f"rounds 2-{HIER_ROUNDS} but the profiled "
                             f"round 4",
          "round_ms": rec["ms"], "profile": rec["profile"],
          "host_draws_ms_per_round": sum(rec["sample_ms"]) / max(
              len(rec["sample_ms"]), 1),
          "host_draws_of": "_sample_batches on the prefetcher's thread "
                           "(100,000 randint draws and the batch gather), "
                           "the mean over the rounds it drew",
          "host_bank_gb": rec["host_bank_gb"],
          "host_chunk_device_bytes": rec["chunk_device_bytes"],
          "peak_mem_gb": peak / 1e9,
          "peak_mem_of": "the run's own, above what earlier phases hold",
          "tier_bytes_last_round": rec["tiers"][-1],
          "savings": res.savings,
          "frac_scalar": [h["frac_scalar"] for h in hist],
          "loss": [h["loss"] for h in hist],
          "wire_bytes": [h["wire_bytes"] for h in hist],
          "test_acc": res.final_eval.get("test_acc"),
          "launches": launches, "launches_by_shape": by_shape})
    return {"history": hist, "params": rec["params"], "peak": peak}


def hier_100k_vs_topk(totals, tmp, host):
    """``hier_100k_vs_topk``: the same spec for 3 rounds with the
    in-memory ``topk`` bank and no tiers must give the ``topk-host`` run's
    first 3 rounds bit for bit (every history field, the params); then
    ``topk-host`` at K = 10,000 (n = 40,000, the same tiers, 3 rounds):
    the K = 100,000 peak may exceed its peak by HIER_PEAK_SHARE of the
    in-memory bank."""
    import torch
    spec = hier_spec(tmp, **{"fl.lbg_variant": "topk", "fl.tiers": None,
                             "rounds": HIER_CMP_ROUNDS})
    res, rec, peak_topk, launches, _ = hier_run(
        "hier_100k_vs_topk", spec, totals, keep_params_at=(HIER_CMP_ROUNDS,))
    want = host["history"][:HIER_CMP_ROUNDS]
    for r, (a, b) in enumerate(zip(res.history, want)):
        for k in HIST_KEYS:
            if a[k] != b[k]:
                fail(f"hier_100k_vs_topk round {r + 1}: {k} {a[k]} (topk) "
                     f"vs {b[k]} (topk-host)")
    pa, pb = rec["params"][HIER_CMP_ROUNDS], host["params"][HIER_CMP_ROUNDS]
    diff = [k for k in pa if not torch.equal(pa[k], pb[k])]
    if diff:
        fail(f"hier_100k_vs_topk: params {diff} differ after round 3")
    # the in-memory bank: K rows of (idx int32, val fp32) per leaf's kb
    from repro_torch.core.lbgm import _block_layout
    k_frac = spec.fl.lbg_kw["k_frac"]
    per_client = sum(8 * nb * kb for nb, _, kb in (
        _block_layout(int(v.numel()), k_frac) for v in pa.values()))
    bank = per_client * spec.fl.num_clients
    small = hier_spec(tmp, **{"fl.num_clients": 10000,
                              "data.kw.n": 40000,
                              "rounds": HIER_CMP_ROUNDS})
    _, _, peak_10k, _, _ = hier_run("hier_10k_topk_host", small, totals)
    grow = host["peak"] - peak_10k
    out = {"phase": "hier_100k_vs_topk", "rounds": HIER_CMP_ROUNDS,
           "bit_for_bit": True,
           "peak_mem_gb_topk_in_memory": peak_topk / 1e9,
           "peak_mem_gb_topk_host_100k": host["peak"] / 1e9,
           "peak_mem_gb_topk_host_10k": peak_10k / 1e9,
           "in_memory_bank_gb": bank / 1e9,
           "peak_growth_mb_10k_to_100k": grow / 1e6,
           "peak_growth_limit_mb": HIER_PEAK_SHARE * bank / 1e6,
           "ms_per_round_topk": steady_ms(rec), "launches": launches}
    emit(out)
    if grow > HIER_PEAK_SHARE * bank:
        fail(f"hier_100k_vs_topk: the topk-host peak grew by "
             f"{grow / 1e6:.1f} MB from K=10,000 to K=100,000, over "
             f"{HIER_PEAK_SHARE * bank / 1e6:.1f} MB")
    return out


def hier_100k_resume(totals, tmp, host):
    """``hier_100k_resume``: ``python -m repro_torch.fed.run --spec
    examples/specs/hier_100k.json --set fl.ckpt_every=2`` (its ``main``,
    in this process) for HIER_SAVE rounds, which checkpoints there; then
    the same with ``--rounds HIER_RESUMED --resume`` in a new engine:
    every record and the params at round HIER_RESUMED equal the
    uninterrupted run's bit for bit."""
    import torch
    from repro_torch.fed import run as fed_run
    from repro_torch.kernels import _build
    ckpt = os.path.join(tmp, "resume.ckpt.npz")
    argv = ["--spec", str(HIER_SPEC), "--set", f"fl.ckpt_path={ckpt}",
            "--set", f"fl.ckpt_every={HIER_SAVE}"]
    outs = []
    t0 = time.perf_counter()
    for rounds, extra in ((HIER_SAVE, []), (HIER_RESUMED, ["--resume"])):
        out = os.path.join(tmp, f"resume-{rounds}.json")
        _build.reset_launch_counts()
        with round_probe(keep_params_at=(HIER_RESUMED,)) as rec:
            if fed_run.main(argv + ["--rounds", str(rounds), "--out", out]
                            + extra) != 0:
                fail("hier_100k_resume: the CLI exited non-zero")
        count_launches("hier_100k_resume", totals,
                       {"lbgm_sparse_decision": None})
        with open(out) as f:
            outs.append((json.load(f)["records"], rec))
    seconds = time.perf_counter() - t0
    (first, _), (resumed, rec) = outs
    if rec["rounds"] != list(range(HIER_SAVE + 1, HIER_RESUMED + 1)):
        fail(f"hier_100k_resume: the resumed run ran rounds {rec['rounds']}")
    for r, (a, b) in enumerate(zip(resumed, host["history"])):
        for k in HIST_KEYS:
            if a[k] != b[k]:
                fail(f"hier_100k_resume round {r + 1}: {k} {a[k]} vs "
                     f"{b[k]} uninterrupted")
    if len(resumed) != HIER_RESUMED or first != resumed[:HIER_SAVE]:
        fail(f"hier_100k_resume: the resumed records are not the first "
             f"run's {HIER_SAVE} and {HIER_RESUMED - HIER_SAVE} more")
    pa, pb = rec["params"][HIER_RESUMED], host["params"][HIER_RESUMED]
    diff = [k for k in pa if not torch.equal(pa[k], pb[k])]
    if diff:
        fail(f"hier_100k_resume: final params {diff} differ")
    out = {"phase": "hier_100k_resume", "saved_at": HIER_SAVE,
           "resumed_to": HIER_RESUMED, "bit_for_bit": True,
           "seconds": seconds, "resumed_ms_per_round": steady_ms(rec),
           "entry": "python -m repro_torch.fed.run --spec "
                    f"{HIER_SPEC.relative_to(ROOT)} --resume (its main)"}
    emit(out)
    return out


def hier_card_vs_cpu(totals, tmp):
    """``hier_card_vs_cpu``: the spec at K = 2,000 (n 8,000), chunk 100,
    tiers [16, 4] shuffled, 3 rounds, on the card and on the CPU from one
    set of initial params: uplink floats, scalar fraction, wire bytes,
    savings and each round's tier bytes equal; loss within 1e-4, the
    run's update within 1e-3 relative L2 (PERF.md §2); no client's sin²
    within 1e-5 of delta. Delta 0.45: at the spec's 0.5 a client's sin²
    lies 2.5e-6 from delta in this cohort (the CPU run), close enough for
    a float-level difference to flip its decision; at 0.45 the nearest
    lies 5.4e-4 away."""
    import numpy as np
    import torch
    from repro_torch.fed.experiment import build_experiment, run_experiment
    spec = hier_spec(tmp, **{
        "fl.num_clients": 2000, "data.kw.n": 8000, "fl.chunk_size": 100,
        "fl.tiers": {"levels": [16, 4], "assign": "shuffle"},
        "fl.delta_threshold": 0.45, "rounds": HIER_CMP_ROUNDS})
    eng, _ = build_experiment(spec, device="cpu")
    p0 = {k: v.numpy() for k, v in eng.params.items()}
    del eng
    runs = {}
    for dev in ("cuda", "cpu"):
        with round_probe(keep_params_at=(HIER_CMP_ROUNDS,)) as rec:
            res = run_experiment(spec, device=dev, params=p0)
        runs[dev] = (res, rec)
    (gres, grec), (cres, crec) = runs["cuda"], runs["cpu"]
    for r, (a, b) in enumerate(zip(gres.history, cres.history)):
        for k in ("uplink_floats", "frac_scalar", "wire_bytes", "savings"):
            if a[k] != b[k]:
                fail(f"hier_card_vs_cpu round {r + 1}: {k} {a[k]} vs {b[k]}")
        if abs(a["loss"] - b["loss"]) > FL_ROBUST_LOSS_RTOL * abs(b["loss"]):
            fail(f"hier_card_vs_cpu round {r + 1}: loss {a['loss']} vs "
                 f"{b['loss']}")
    if grec["tiers"] != crec["tiers"]:
        fail(f"hier_card_vs_cpu: tier bytes {grec['tiers']} vs "
             f"{crec['tiers']}")
    num = den = 0.0
    for k, v0 in p0.items():
        u_g = grec["params"][HIER_CMP_ROUNDS][k].double() - \
            torch.from_numpy(v0).double()
        u_c = crec["params"][HIER_CMP_ROUNDS][k].double() - \
            torch.from_numpy(v0).double()
        num += float(((u_g - u_c) ** 2).sum())
        den += float((u_c ** 2).sum())
    rel = (num / max(den, 1e-300)) ** 0.5
    delta = spec.fl.delta_threshold
    margin = min(float(np.min(np.abs(s - delta))) for s in grec["sin2"])
    out = {"phase": "hier_card_vs_cpu", "K": 2000, "chunk": 100,
           "tiers": spec.fl.tiers, "rounds": HIER_CMP_ROUNDS,
           "update_rel_l2": rel, "sin2_margin": margin,
           "tier_bytes": grec["tiers"],
           "frac_scalar": [h["frac_scalar"] for h in gres.history],
           "gpu_ms_per_round": gres.us_per_round / 1e3,
           "cpu_ms_per_round": cres.us_per_round / 1e3}
    emit(out)
    if rel > FL_ROBUST_UPDATE_RTOL:
        fail(f"hier_card_vs_cpu: update {rel:.3g} relative L2 off the CPU's")
    if margin < 1e-5:
        fail(f"hier_card_vs_cpu: a client's sin² lies {margin:.3g} from "
             "delta")
    return out


def fl_lm_qwen3_topk_host(totals, inmem):
    """``fl_lm_qwen3_topk_host``: ``fl_lm_qwen3_topk_int8``'s settings
    (full-width qwen3, K=4, chunk 2, top-k 0.01, int8, 2 rounds) with the
    ``topk-host`` bank and tiers [2] (accounting-only under a codec): its
    history equals the in-memory phase's bit for bit; the last round
    profiled for the streamer's copies against the chunk's kernels."""
    spec = fl_lm_spec("qwen3-1.7b", **{
        "fl.lbg_variant": "topk-host", "fl.lbg_kw": {"k_frac": 0.01},
        "fl.chunk_size": 2, "fl.codec": "int8", "fl.tiers": [2],
        "rounds": len(inmem)})
    want = fl_lm_expected(spec)
    history, final, rec, peak = fl_lm_run(spec, profile_round=len(inmem))
    for got in rec["launches"]:
        for k, n in got.items():
            totals[k] += n
    for r, (a, b) in enumerate(zip(history, inmem)):
        for k in HIST_KEYS:
            if a[k] != b[k]:
                fail(f"fl_lm_qwen3_topk_host round {r + 1}: {k} {a[k]} vs "
                     f"{b[k]} in memory")
    out = fl_lm_record("fl_lm_qwen3_topk_host", spec, history, final, rec,
                       peak, want, tiers=spec.fl.tiers,
                       host_bank_gb=rec["host_bank_gb"],
                       host_chunk_device_bytes=rec["chunk_device_bytes"],
                       profile=rec["profile"], bit_for_bit_in_memory=True,
                       entry="repro_torch.fed.experiment.run_experiment")
    emit(out)
    return out


# ------------------------------------------- the (clients, model) mesh

#: fl_sharded_mesh_card's meshes, each a gloo world of c·m ranks on the
#: one card
MESH_CARD = ([2, 2], [1, 2])
MESH_CARD_ROUNDS = 2
MESH_LOSS_RTOL = 1e-5
MESH_PARAMS_TOL = dict(rtol=1e-4, atol=1e-6)
#: each client's sin² on a mesh against the chunked run's
MESH_SIN2_TOL = dict(rtol=1e-5, atol=1e-6)
#: the CPU rank tests' FCN (tests/test_torch_sharded_ranks.py): at d_model
#: 704 fc1/w's 9 live block rows of 16 reach model rank 1 of m = 2, and
#: delta 0.85 makes recycle rounds, so the model group's sum of the
#: scalars decides a round
MESH_WIDE = {
    "name": "mesh-d704", "model": {"name": "fcn", "kw": {"d_model": 704}},
    "data": {"name": "mixture", "kw": {"n": 600, "n_eval": 50, "seed": 0}},
    "partition": {"name": "iid", "kw": {"seed": 0}},
    "fl": {"lbg_variant": "topk", "lbg_kw": {"k_frac": 0.1},
           "num_clients": 10, "tau": 2, "lr": 0.05, "batch_size": 16,
           "seed": 0, "delta_threshold": 0.85, "chunk_size": 6,
           "sample_frac": 0.5, "scheduler": "chunked"},
    "rounds": 3,
    "eval": {"every": 0, "final": False, "verbose": False}}


@contextlib.contextmanager
def collective_probe():
    """Count and time every ``torch.distributed.all_reduce`` and
    ``broadcast`` of the run (the only collectives the sharded path
    makes), each between two synchronisations of the card, by its group's
    size (and the broadcasts apart: ``model_sharding="auto"``'s reshards).
    The round times taken under it include those synchronisations."""
    import torch.distributed as dist
    real = dist.all_reduce, dist.broadcast
    rec = {"calls": 0, "ms": 0.0, "bytes": 0, "by_group_size": {},
           "broadcast": {"calls": 0, "ms": 0.0, "bytes": 0}}

    def probe(i, kind):
        def timed(t, *a, group=None, **kw):
            sync()
            t0 = time.perf_counter()
            out = real[i](t, *a, group=group, **kw)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            n = dist.get_world_size(group)
            g = rec["by_group_size"].setdefault(
                str(n), {"calls": 0, "ms": 0.0, "bytes": 0})
            for r in (rec, g) + ((rec["broadcast"],) if kind else ()):
                r["calls"] += 1
                r["ms"] += ms
                r["bytes"] += t.numel() * t.element_size()
            return out
        return timed

    dist.all_reduce, dist.broadcast = probe(0, False), probe(1, True)
    try:
        yield rec
    finally:
        dist.all_reduce, dist.broadcast = real


def _leaf_bytes(tree):
    out = {}
    for name, leaf in tree.items():
        leaves = leaf.values() if isinstance(leaf, dict) else [leaf]
        out[name] = int(sum(x.numel() * x.element_size() for x in leaves))
    return out


def _launch_shapes():
    from repro_torch.kernels import _build
    return ({k: v for k, v in _build.LAUNCHES.items() if v},
            {k: dict(v) for k, v in _build.LAUNCH_SHAPES.items() if v})


def mesh_engine_job(job):
    """An engine job of :func:`mesh_rank`: ``build_experiment`` on the
    job's device (the sharded scheduler's mesh joins the launcher's world
    here), its rounds through the engine's prefetcher, timed per round
    with the launch counters set to 0 first and every all_reduce counted
    (:func:`collective_probe`). Returns the rank's record."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.fed.experiment import ExperimentSpec, build_experiment
    from repro_torch.kernels import _build
    spec = ExperimentSpec.from_dict(job["spec"])
    with np.load(job["params"]) as z:
        params = {k: z[k] for k in z.files}
    dev = job["device"]
    eng, _ = build_experiment(spec, params=params, device=dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rng = np.random.RandomState(spec.fl.seed + 1)
    ms, coll_ms = [], []
    with collective_probe() as coll:
        _build.reset_launch_counts()
        src = eng.prefetcher(rng)
        try:
            for _ in range(job["rounds"]):
                sync()
                t0, c0 = time.perf_counter(), coll["ms"]
                eng.run_round(src)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                coll_ms.append(coll["ms"] - c0)
        finally:
            src.close()
        launches, shapes = _launch_shapes()
    sched = eng.sched
    rec = {"history": eng.history,
           "params": {k: v.cpu().numpy() for k, v in eng.params.items()},
           "bank_bytes": _leaf_bytes(eng.lbg),
           "global_bank_bytes": _leaf_bytes(sched.global_banks(eng.lbg)),
           "msharded": sched._msharded, "chunk": eng._chunk,
           "local": sched.local, "client_rank": sched.client_rank,
           "model_rank": sched.model_rank, "backend": dist.get_backend(),
           "cuda_device": (torch.cuda.current_device() if dev == "cuda"
                           else None),
           "sin2": [x.tolist() for x in eng.sin2_history],
           "launches": launches, "launches_by_shape": shapes,
           "collectives": coll, "collective_ms": coll_ms, "ms": ms,
           "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                       if dev == "cuda" else None)}
    eng.close()
    return rec


def mesh_cli_job(job, rank):
    """A CLI job of :func:`mesh_rank`: ``repro_torch.fed.run.main`` with
    ``{rank}`` in its arguments replaced by this rank, as ``torchrun
    --nproc-per-node N -m repro_torch.fed.run`` runs it on each rank;
    what it printed, its return code, its launches and whether the world
    was ended (the CLI ends a launcher's world)."""
    import io
    import torch.distributed as dist
    from repro_torch.fed import run as fed_run
    from repro_torch.kernels import _build
    argv = [a.replace("{rank}", str(rank)) for a in job["cli"]]
    out = io.StringIO()
    _build.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = fed_run.main(argv)
    launches, shapes = _launch_shapes()
    return {"rc": rc, "stdout": out.getvalue(),
            "world_ended": not dist.is_initialized(),
            "launches": launches, "launches_by_shape": shapes}


def mesh_rank(root, rank, world, port, jobs, out_dir):
    """One rank of ``fl_sharded_mesh_card``'s world, started as
    ``torchrun`` starts one: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` in its environment and no process
    group of its own. The first engine's mesh starts the group
    (``launch.mesh.ensure_world``: ``env://``, the backend of
    ``backend_for``, the card ``LOCAL_RANK`` modulo the cards). Runs the
    engine jobs (:func:`mesh_engine_job`), then the CLI job
    (:func:`mesh_cli_job`), which ends the world, and writes
    ``<tag>.r<rank>.pt`` for each; an exception is written to
    ``<tag>.r<rank>.err``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    sys.path.insert(0, str(Path(root) / "src"))
    import gc
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import shutdown
    tag = None
    try:
        for job in jobs:
            tag = job["tag"]
            rec = (mesh_cli_job(job, rank) if "cli" in job
                   else auto_engine_job(job) if job.get("auto")
                   else mesh_engine_job(job))
            torch.save(rec, os.path.join(out_dir, f"{tag}.r{rank}.pt"))
            # the next job starts on an emptied cache: the auto arms run
            # one after another, each near the card's share of a rank
            del rec
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    except BaseException:
        with open(os.path.join(out_dir, f"{tag}.r{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        shutdown()


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_mesh(worlds, out_dir, timeout=600):
    """Run each ``(world, jobs)`` of ``worlds`` on ``world`` spawned ranks
    (:func:`mesh_rank`), every world at once, each on its own port; every
    process is joined (or killed) before it returns. Fails on any rank's
    error or exit code. Returns ``{tag: [record of rank 0, 1, ...]}``."""
    return join_mesh(worlds, out_dir, start_mesh(worlds, out_dir), timeout)


def start_mesh(worlds, out_dir):
    """Start :func:`spawn_mesh`'s ranks and return their processes
    (daemons: a failed check that ends this script ends them too)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for world, jobs in worlds:
        port = free_port()
        procs += [ctx.Process(target=mesh_rank, daemon=True, args=(
            str(ROOT), r, world, port, jobs, out_dir)) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_mesh(worlds, out_dir, procs, timeout=600):
    """Join (or kill) the ranks :func:`start_mesh` started; the rest of
    :func:`spawn_mesh`."""
    import torch
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.join(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    errs = sorted(Path(out_dir).glob("*.err"))
    if errs or any(p.exitcode != 0 for p in procs):
        text = "\n".join(e.read_text() for e in errs)[-6000:]
        fail(f"mesh ranks exited {[p.exitcode for p in procs]}:\n{text}")
    return {job["tag"]: [torch.load(
        os.path.join(out_dir, f"{job['tag']}.r{r}.pt"), weights_only=False)
        for r in range(world)] for world, jobs in worlds for job in jobs}


def mesh_reference(spec, device, path):
    """The chunked run of ``spec`` on ``device`` from the model's own
    init, whose params go to ``path`` for the ranks: (history, params,
    sin² rows)."""
    import numpy as np
    import torch
    from repro_torch.fed.experiment import build_experiment
    ref, _ = build_experiment(spec, device=device)
    np.savez(path, **{k: v.cpu().numpy() for k, v in ref.params.items()})
    hist = ref.run(spec.rounds)
    out = (hist, {k: v.cpu().numpy() for k, v in ref.params.items()},
           [np.asarray(s) for s in ref.sin2_history])
    ref.close()
    del ref
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def check_mesh_job(label, mesh, recs, ref, device):
    """Every rank of ``label`` holds the same history and params; against
    the chunked run ``ref``: the exact fields equal, loss within
    MESH_LOSS_RTOL, params within MESH_PARAMS_TOL, each client's sin²
    within MESH_SIN2_TOL; the world is gloo on card 0; each rank's bank
    bytes 1/(c·m) of the bank for a model-sharded leaf and 1/c for a
    replicated one. Returns (params max abs error, sin² max abs error)."""
    import numpy as np
    c, m = mesh
    ref_hist, ref_params, ref_sin2 = ref
    r0 = recs[0]
    for r, rec in enumerate(recs):
        if rec["backend"] != "gloo":
            fail(f"{label}: rank {r} runs on {rec['backend']}, not gloo "
                 f"({c * m} ranks share one card)")
        if device == "cuda" and rec["cuda_device"] != 0:
            fail(f"{label}: rank {r} on card {rec['cuda_device']}")
        if r and (rec["history"] != r0["history"] or any(
                not np.array_equal(rec["params"][k], v)
                for k, v in r0["params"].items())):
            fail(f"{label}: rank {r} holds another history or params than "
                 f"rank 0")
    if len(r0["history"]) != len(ref_hist):
        fail(f"{label}: {len(r0['history'])} rounds, not {len(ref_hist)}")
    for r, (a, b) in enumerate(zip(ref_hist, r0["history"])):
        for k in ("uplink_floats", "frac_scalar", "wire_bytes", "savings"):
            if a[k] != b[k]:
                fail(f"{label} round {r + 1}: {k} {b[k]} vs {a[k]} chunked")
        if not abs(a["loss"] - b["loss"]) <= MESH_LOSS_RTOL * abs(a["loss"]):
            fail(f"{label} round {r + 1}: loss {b['loss']} vs {a['loss']} "
                 f"chunked")
    err = 0.0
    for k, v in ref_params.items():
        p = r0["params"][k]
        if not np.allclose(p, v, **MESH_PARAMS_TOL):
            fail(f"{label}: params {k} off the chunked run's by "
                 f"{float(np.abs(p - v).max()):.3g}")
        err = max(err, float(np.abs(p - v).max()))
    sin2_err = 0.0
    for r, rec in enumerate(recs):
        for rnd, (got, want) in enumerate(zip(rec["sin2"], ref_sin2)):
            got = np.asarray(got)
            if got.shape != want.shape or not np.allclose(
                    got, want, **MESH_SIN2_TOL):
                fail(f"{label}: rank {r}'s sin2 of round {rnd + 1} off the "
                     f"chunked run's: {got} vs {want}")
            sin2_err = max(sin2_err, float(np.abs(got - want).max()))
    ms = r0["msharded"] or {}
    for r, rec in enumerate(recs):
        for name, b in rec["bank_bytes"].items():
            div = c * m if ms.get(name) else c
            if b * div != rec["global_bank_bytes"][name]:
                fail(f"{label}: rank {r} holds {b} bank bytes of {name}, "
                     f"not 1/{div} of {rec['global_bank_bytes'][name]}")
    return err, sin2_err


def rank_row_launches(label, mesh, recs, params_like, k_frac, device):
    """Each model rank's decision launches at its rows of each
    model-sharded leaf: the live elements ``[q·nb/m·block, (q+1)·nb/m·
    block)`` of the flat leaf at the rank's C/c clients. Fails when a
    rank with live rows made no such launch on the card; returns
    ``{leaf: {model rank: launches}}``."""
    from repro_torch.core.lbgm import _block_layout
    c, m = mesh
    out = {}
    for name, on in (recs[0]["msharded"] or {}).items():
        if not on:
            continue
        size = int(params_like[name].size)
        nb, block, kb = _block_layout(size, k_frac)
        nb_l = nb // m
        out[name] = {}
        for rec in recs:
            q = rec["model_rank"]
            lo, hi = min(size, q * nb_l * block), min(size,
                                                      (q + 1) * nb_l * block)
            shp = (rec["local"], hi - lo, nb_l, block, kb)
            n = rec["launches_by_shape"].get(
                "lbgm_sparse_decision", {}).get(shp, 0)
            out[name][q] = out[name].get(q, 0) + n
            if device == "cuda" and hi > lo and not n:
                fail(f"{label}: model rank {q} never launched the decision "
                     f"at its rows of {name} {shp}")
    return out


def fl_sharded_mesh_card(totals, tmp, device="cuda"):
    """``fl_sharded_mesh_card``: the ``"sharded"`` scheduler with the
    ``"topk-sharded"`` store on the ``(2, 2)`` and ``(1, 2)`` meshes, 4 and
    2 ranks spawned on the one card as ``torchrun`` spawns them (each
    mesh's process group started by the engine: gloo carrying CUDA
    tensors). Each world runs, in order:

    * the paper cohort (FCN, K=100, tau 2, lr 0.05, b 16, label skew,
      chunk 10) at k_frac 0.1, delta 0.2, MESH_CARD_ROUNDS rounds;
    * ``MESH_WIDE``, the CPU rank tests' FCN at d_model 704 (K=10 with
      pad clients, sample_frac 0.5, delta 0.85), MESH_CARD_ROUNDS rounds: it
      recycles,
      and fc1/w has live rows on model rank 1, whose decision launch is
      checked;
    * the paper cohort through the CLI, ``repro_torch.fed.run.main`` on
      every rank: rank 0 alone prints and writes ``--out``, every rank
      returns 0 and the world ends; its history equals the first job's
      and its round time is taken without the probe.

    The first two are held against their chunked runs on the card from
    the same weights (:func:`check_mesh_job`). Records the decision's
    launch shapes at the rank slices, the collectives (calls, bytes and
    ms a round, between synchronisations: the probed round times include
    them) and ms a round. Both worlds run at once (6 processes on the
    card), so their times are each other's neighbours'."""
    import numpy as np
    from repro_torch.fed.experiment import ExperimentSpec
    base = fl_spec("fcn", lbg_variant="topk", lbg_kw={"k_frac": 0.1},
                   chunk_size=10)
    base = base.with_overrides({"rounds": MESH_CARD_ROUNDS,
                                "eval.final": False})
    wide = ExperimentSpec.from_dict(MESH_WIDE).with_overrides(
        {"rounds": MESH_CARD_ROUNDS})
    paths = {"paper": os.path.join(tmp, "mesh_params.npz"),
             "wide": os.path.join(tmp, "mesh_wide_params.npz")}
    refs = {"paper": mesh_reference(base, device, paths["paper"]),
            "wide": mesh_reference(wide, device, paths["wide"])}
    worlds = []
    for c, m in MESH_CARD:
        jobs = []
        for what, spec in (("paper", base), ("wide", wide)):
            d = spec.to_dict()
            d["fl"].update(scheduler="sharded", mesh=[c, m],
                           lbg_variant="topk-sharded")
            jobs.append({"tag": f"{what}_{c}x{m}", "spec": d,
                         "params": paths[what], "rounds": MESH_CARD_ROUNDS,
                         "device": device})
        spec_path = os.path.join(tmp, f"cli_{c}x{m}.json")
        with open(spec_path, "w") as f:
            json.dump(jobs[0]["spec"], f)
        jobs.append({"tag": f"cli_{c}x{m}", "cli": [
            "--spec", spec_path, "--device", device, "--out",
            os.path.join(tmp, f"cli_{c}x{m}.r{{rank}}.json")]})
        worlds.append((c * m, jobs))
    t0 = time.perf_counter()
    got = spawn_mesh(worlds, tmp)
    wall = time.perf_counter() - t0
    rounds = MESH_CARD_ROUNDS
    for c, m in MESH_CARD:
        label = f"fl_sharded_mesh_card_{c}x{m}"
        recs, wrecs = got[f"paper_{c}x{m}"], got[f"wide_{c}x{m}"]
        cli = got[f"cli_{c}x{m}"]
        err, sin2_err = check_mesh_job(label, [c, m], recs, refs["paper"],
                                       device)
        werr, wsin2_err = check_mesh_job(f"{label} d704", [c, m], wrecs,
                                         refs["wide"], device)
        r0, w0 = recs[0], wrecs[0]
        if not any(h["frac_scalar"] > 0 for h in w0["history"]):
            fail(f"{label} d704: no recycle round")
        with np.load(paths["wide"]) as z:
            wide_rows = rank_row_launches(f"{label} d704", [c, m], wrecs,
                                          {k: z[k] for k in z.files}, 0.1,
                                          device)
        # the CLI: rank 0 alone prints and writes --out; every rank
        # returns 0 and leaves the world ended
        outs = [os.path.exists(os.path.join(tmp, f"cli_{c}x{m}.r{r}.json"))
                for r in range(c * m)]
        if [x["rc"] for x in cli] != [0] * (c * m) or not all(
                x["world_ended"] for x in cli):
            fail(f"{label} CLI: return codes {[x['rc'] for x in cli]}, "
                 f"world ended {[x['world_ended'] for x in cli]}")
        if outs != [True] + [False] * (c * m - 1) or any(
                x["stdout"] for x in cli[1:]) or "rounds on" not in \
                cli[0]["stdout"]:
            fail(f"{label} CLI: --out written by {outs}, printed "
                 f"{[bool(x['stdout']) for x in cli]}")
        with open(os.path.join(tmp, f"cli_{c}x{m}.r0.json")) as f:
            res = json.load(f)
        cli_hist = res["records"]
        for r, (a, b) in enumerate(zip(r0["history"], cli_hist)):
            for k in ("uplink_floats", "frac_scalar", "wire_bytes",
                      "savings"):
                if a[k] != b[k]:
                    fail(f"{label} CLI round {r + 1}: {k} {b[k]} vs {a[k]}")
            if not abs(a["loss"] - b["loss"]) <= MESH_LOSS_RTOL * abs(
                    a["loss"]):
                fail(f"{label} CLI round {r + 1}: loss {b['loss']} vs "
                     f"{a['loss']}")
        shapes = {}
        for rec in recs + wrecs + cli:
            for k, n in rec["launches"].items():
                totals[k] += n
            for k, v in rec["launches_by_shape"].items():
                for shp, n in v.items():
                    SHAPE_TOTALS.setdefault(k, {})
                    SHAPE_TOTALS[k][shp] = SHAPE_TOTALS[k].get(shp, 0) + n
                    shapes.setdefault(k, {})
                    shapes[k][shp] = shapes[k].get(shp, 0) + n
        if device == "cuda" and not shapes.get("lbgm_sparse_decision"):
            fail(f"{label}: the decision kernel never launched")
        ref_hist = refs["paper"][0]
        emit({"phase": label, "mesh": [c, m], "ranks": c * m,
              "backend": f"{r0['backend']} (CUDA tensors)"
              if device == "cuda" else r0["backend"],
              "process_group": "started by the engine's mesh from the "
                               "launcher's environment (env://)",
              "K": 100, "chunk": r0["chunk"],
              "clients_per_rank_chunk": r0["local"],
              "rounds": rounds, "delta": 0.2, "k_frac": 0.1,
              "model_sharded_leaves": r0["msharded"] or {},
              "ms_per_round_rank0": r0["ms"],
              "ms_per_round_of": "each round under the collective probe "
                                 "(two card synchronisations around each "
                                 "all_reduce); both meshes' 6 ranks share "
                                 "the card and the host's 8 cores",
              "cli_ms_per_round": res["duration_s"] / rounds * 1e3,
              "cli_ms_per_round_of": "the CLI's run of the same spec, no "
                                     "probe (run_experiment's round time; "
                                     "the other world may run beside it)",
              "cli_history_bit_for_bit": all(
                  a[k] == b[k] for a, b in zip(r0["history"], cli_hist)
                  for k in a if k in b),
              "collective_ms_by_round": [rec["collective_ms"]
                                         for rec in recs],
              "collective_calls_per_round":
                  r0["collectives"]["calls"] / rounds,
              "collective_bytes_per_round":
                  r0["collectives"]["bytes"] / rounds,
              "collectives_by_group_size": r0["collectives"]["by_group_size"],
              "bank_bytes_per_rank": [rec["bank_bytes"] for rec in recs],
              "global_bank_bytes": r0["global_bank_bytes"],
              "decision_launch_shapes": [
                  [list(shp), n] for shp, n in
                  shapes.get("lbgm_sparse_decision", {}).items()],
              "launches": {k: sum(rec["launches"].get(k, 0) for rec in recs)
                           for k in r0["launches"]},
              "peak_gb_per_rank": [rec["peak_gb"] for rec in recs],
              "loss": [h["loss"] for h in r0["history"]],
              "loss_chunked": [h["loss"] for h in ref_hist],
              "frac_scalar": [h["frac_scalar"] for h in r0["history"]],
              "uplink_floats": [h["uplink_floats"] for h in r0["history"]],
              "params_max_abs_err_vs_chunked": err,
              "sin2_max_abs_err_vs_chunked": sin2_err,
              "d704": {
                  "K": 10, "chunk": w0["chunk"], "delta": 0.85,
                  "frac_scalar": [h["frac_scalar"] for h in w0["history"]],
                  "loss": [h["loss"] for h in w0["history"]],
                  "model_sharded_leaves": w0["msharded"] or {},
                  "decision_launches_at_rank_rows": wide_rows,
                  "bank_bytes_per_rank": [rec["bank_bytes"]
                                          for rec in wrecs],
                  "collective_calls_per_round":
                      w0["collectives"]["calls"] / rounds,
                  "collective_ms_by_round_rank0": w0["collective_ms"],
                  "ms_per_round_rank0": w0["ms"],
                  "params_max_abs_err_vs_chunked": werr,
                  "sin2_max_abs_err_vs_chunked": wsin2_err},
              "seconds_both_meshes_with_spawn": wall})


# ------------------------------------------------ CPU sides of card vs CPU

#: intra-op threads of the worker that runs the card-vs-CPU phases' CPU
#: sides beside the card's phases (of the host's 8 cores)
CPU_WORKER_THREADS = 3


def train_cpu_side(arch, T, K=2, b=1, steps=2):
    """The CPU side of ``lm_train_card_vs_cpu`` for ``arch``: the weights
    of ``train_cpu_params`` and ``launch.train``'s batch (with its stub),
    ``make_train_step`` for ``steps`` steps. Returns the losses, every
    client's sin² and decision, and step 1's aggregated update."""
    from repro_torch.train import trainer as tr
    cfg, params, batch = train_cpu_inputs(arch, T, K, b)
    state, _ = tr.init_train_state(None, cfg, K, device="cpu",
                                   params=params)
    with train_probe(keep_update=True) as rec:
        step = tr.make_train_step(cfg, K, 0.05, delta=TRAIN_DELTA)
        losses = []
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    return {"losses": losses, "sin2": rec["sin2"], "sent": rec["sent"],
            "update": rec["update"]}


def train_cpu_inputs(arch, T, K, b):
    """(config, params, batch) of a card-vs-CPU training job: the arch at
    full width, ``CARD_CPU_DEPTH``'s depth, fp32; weights drawn on the
    host from seed 0; ``launch.train``'s first batch of K clients, b
    sequences of T tokens, with its stub embeddings."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import init_lm
    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              **CARD_CPU_DEPTH[arch])
    params, _ = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    args = launch_train.parse_args(
        ["--arch", arch, "--clients", str(K), "--batch", str(b),
         "--seq", str(T), "--pool", "1"])
    batch = next(launch_train.client_batches(
        args, cfg.vocab_size, "cpu",
        launch_train.stub_embeds(args, cfg, "cpu")))
    return cfg, params, batch


def fl_cpu_side(arch, K, T, rounds):
    """The CPU side of ``fl_lm_card_vs_cpu`` for ``arch``: the spec of
    ``fl_cvc_spec`` through ``run_experiment`` on the CPU from the
    ``"lm"`` component's host draw of seed 0. Returns the history, every
    round's sin², ms a round and round 1's aggregated update."""
    from repro_torch.fed.experiment import run_experiment
    spec, params = fl_cvc_inputs(arch, K, T, rounds)
    with fl_probe(keep_update=True) as rec:
        cpu = run_experiment(spec, device="cpu", params=params)
    return {"history": cpu.history, "sin2": [s.tolist() for s in cpu.sin2],
            "ms_per_round": cpu.us_per_round / 1e3, "update": rec["update"]}


def fl_cvc_inputs(arch, K, T, rounds):
    """(spec, params) of a card-vs-CPU FL job: ``arch`` at depth 2 in fp32,
    K clients, FL_CPU_SEQS sequences of T tokens each, ``rounds`` rounds,
    dense store; the ``"lm"`` component's weights drawn on the host from
    seed 0, as numpy arrays."""
    from repro_torch.fed.experiment import MODELS
    spec = fl_lm_spec(arch, **{
        "model.kw.n_layers": 2, "model.kw.dtype": "float32",
        "fl.num_clients": K, "data.kw.seq_len": T,
        "data.kw.n": FL_CPU_SEQS * K, "rounds": rounds,
        "eval.final": False})
    p, _, _ = MODELS.get("lm")(seed=0, device="cpu", **spec.model.kw)
    return spec, {k: v.numpy() for k, v in p.items()}


CPU_SIDES = {"train": train_cpu_side, "fl": fl_cpu_side}


def cpu_worker(root, jobs, out_dir):
    """The worker process: each job's CPU side in order, its result saved
    to ``out_dir/<name>.pt`` (written whole, then renamed); an exception
    is saved as the job's result. It never touches the card."""
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    torch.set_num_threads(CPU_WORKER_THREADS)
    for kind, name, kw in jobs:
        t0 = time.perf_counter()
        try:
            res = CPU_SIDES[kind](**kw)
        except BaseException:
            res = {"error": traceback.format_exc()}
        res["seconds"] = time.perf_counter() - t0
        res["peak_rss_gib"] = peak_rss_gib()
        part = os.path.join(out_dir, name + ".part")
        torch.save(res, part)
        del res
        os.replace(part, os.path.join(out_dir, name + ".pt"))


class CpuWorker:
    """The card-vs-CPU phases' CPU sides, run in a spawned process beside
    the card's phases (``CPU_WORKER_THREADS`` threads): the jobs start
    when it is made, and ``result(name)`` waits for one, reads it and
    deletes its file. ``close()`` ends the process."""

    def __init__(self, jobs, out_dir):
        import multiprocessing
        self.out_dir = out_dir
        self.t0 = time.perf_counter()
        self.proc = multiprocessing.get_context("spawn").Process(
            target=cpu_worker, args=(str(ROOT), jobs, out_dir), daemon=True)
        self.proc.start()

    def result(self, name, timeout=900):
        import torch
        path = os.path.join(self.out_dir, name + ".pt")
        t0 = time.perf_counter()
        while not os.path.exists(path):
            if not self.proc.is_alive():
                fail(f"the CPU worker ended (exit {self.proc.exitcode}) "
                     f"before {name}")
            if time.perf_counter() - t0 > timeout:
                fail(f"the CPU worker gave no {name} in {timeout} s")
            time.sleep(0.5)
        res = torch.load(path, mmap=True)
        os.remove(path)
        if "error" in res:
            fail(f"the CPU side of {name} raised:\n{res['error']}")
        res["waited_s"] = time.perf_counter() - t0
        res["read_at_s"] = time.perf_counter() - self.t0
        return res

    def close(self):
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join(timeout=30)


def peak_rss_gib():
    """This process's peak resident memory so far, GiB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def host_memory():
    """The host's memory (GiB, from /proc/meminfo) and the script's own
    peak resident memory so far."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":", 1)
            if k in ("MemTotal", "MemAvailable"):
                info[k] = int(v.split()[0]) / 2 ** 20
    return {"total_gib": info.get("MemTotal"),
            "available_gib": info.get("MemAvailable"),
            "main_peak_rss_gib": peak_rss_gib()}


def update_rel_l2(got, want):
    """||got - want|| / ||want|| over every leaf, in fp64, on ``got``'s
    device."""
    import torch
    num = den = 0.0
    for k, v in got.items():
        w = want[k].to(v.device)
        num += float(((v - w) ** 2).sum(dtype=torch.float64))
        den += float((w ** 2).sum(dtype=torch.float64))
    return (num / max(den, 1e-300)) ** 0.5


# ------------------------------------------------------------------- main

def lm_phases(totals):
    """LM serving, then training: full-width qwen3-1.7b and rwkv6-3b, then
    the rest of the zoo (MoE cut in depth), one model at a time; the
    training phases that start from the serving weights (seed 0, as
    launch.train draws them) run before they go, mixtral's top-k training
    and FL round on a model of their own (``TOPK_RUNS``' depth). The
    training launches stay in their own records, out of the totals."""
    import torch
    from repro_torch.launch import train as launch_train
    with tempfile.TemporaryDirectory() as out_dir:
        for arch in (*LM_KERNEL, *ZOO):
            cfg, params = lm_model(arch)
            lm_prefill(arch, cfg, params, totals)
            lm_serve(arch, cfg, params, totals)
            if arch in TRAIN_RUNS:
                lm_train_layers(arch, params, cfg, launch_train.parse_args(
                    train_argv(arch, *TRAIN_RUNS[arch])))
            if arch == "qwen3-1.7b":
                lm_train_topk(arch, params, cfg)
            del params
            torch.cuda.empty_cache()
            if arch in TRAIN_RUNS:
                lm_train(arch, out_dir)
            if arch in TOPK_RUNS and arch != "qwen3-1.7b":
                _, depth, K, b, T, steps, _, _ = TOPK_RUNS[arch]
                cfg, params = lm_model(arch, depth)
                lm_train_layers(arch, params, cfg, launch_train.parse_args(
                    train_argv(arch, K, b, T, steps)))
                lm_train_topk(arch, params, cfg)
                fl_lm_mixtral_topk(params, depth)
                del params
                torch.cuda.empty_cache()
                lm_train_fp32_vs_plain(arch)


def main():
    import torch
    global T_START, SMI_LINE
    t_start = T_START = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch.fed.experiment  # noqa: F401
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import _build

    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = SMI_LINE = smi[0] if smi else "nvidia-smi: no output"
    emit({"phase": "card", "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count(),
          "cpu_threads": torch.get_num_threads(), "cpu_count": os.cpu_count(),
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in
                        libs.items()},
          "ptxas": ptxas_usage(_build.BUILD_LOGS),
          "sass_tensor_core_instructions": tensor_core_instructions(libs)})

    errs = kernel_checks()
    errs.update(lm_kernel_checks())
    # the kernels line's times and kernel counts, taken here on a card that
    # has run nothing else yet; its launches are the main path's, below
    kernels = kernel_line(errs)
    gen = torch.Generator().manual_seed(4)
    kernels += [flash_entry(gen, errs), scan_entry(gen, errs)]
    lm_train_kernel_checks()

    totals = {k: 0 for k in _build.LAUNCHES}
    topk = {"lbg_variant": "topk", "lbg_kw": {"k_frac": 0.1}}
    run_phase("fcn_dense", fl_spec("fcn"), False, ["lbgm_projection"],
              totals)
    run_phase("fcn_topk", fl_spec("fcn", **topk), False,
              ["lbgm_sparse_decision"], totals)
    run_phase("fcn_topk_index_order",
              fl_spec("fcn", delta_threshold=0.7, **topk), True,
              ["lbgm_sparse_decision_two_pass"], totals)
    run_phase("cnn_dense", fl_spec("cnn"), False, ["lbgm_projection"],
              totals)
    # the compressed uplink: wire codecs over the top-k store, compressor
    # stacks over the dense store
    int8 = dict(topk, delta_threshold=0.9, codec="int8")
    codec_kernels = ["lbgm_sparse_decision", "lbgm_dequant_accum"]
    run_phase("fcn_topk_int8", fl_spec("fcn", **int8), False, codec_kernels,
              totals)
    run_phase("fcn_topk_fp8",
              fl_spec("fcn", **dict(int8, codec="fp8",
                                    codec_kw={"stochastic": False})),
              False, codec_kernels, totals)
    run_phase("fcn_dense_topk_ef",
              fl_spec("fcn", compressor="topk",
                      compressor_kw={"k_frac": 0.1}, error_feedback=True,
                      delta_threshold=0.75),
              False, ["lbgm_projection"], totals)
    run_phase("fcn_dense_atomo",
              fl_spec("fcn", compressor="atomo", compressor_kw={"rank": 2},
                      delta_threshold=0.5),
              False, ["lbgm_projection"], totals)

    profile_round("fcn_dense", fl_spec("fcn"))
    profile_round("fcn_topk", fl_spec("fcn", **topk))
    profile_round("fcn_topk_int8", fl_spec("fcn", **int8))
    uplink_launches()
    # fl_sharded_auto_recurrent_card: its (1, 1) references here, then its
    # 2 ranks beside the robust, scale-out and mesh phases (host-bound,
    # little of the card: checks whose times are not cells); placed after
    # the card-vs-CPU phases they added 117 s to a 1,360 s run (NVIDIA H100
    # 80GB HBM3, 700 W). fl_sharded_auto_moe_card (mixtral, 1 layer) is
    # their third arm, fl_sharded_auto_vlm_card (qwen2-vl, 2 layers) their
    # fourth
    rec_tmp = tempfile.mkdtemp(prefix="chip_smoke_auto_recurrent_")
    rec_run = auto_launch(
        rec_tmp, auto_refs(AUTO_RECURRENT + AUTO_MOE + AUTO_VLM, rec_tmp),
        "fl_sharded_auto_recurrent_card")
    robust_phases(totals)

    # one-host scale-out: the shipped 100,000-client spec on the topk-host
    # bank, held against the in-memory bank, a resume and the CPU
    with tempfile.TemporaryDirectory() as tmp:
        t_hier = time.perf_counter()
        host = hier_100k_topk_host(totals, tmp)
        hier_100k_vs_topk(totals, tmp, host)
        hier_100k_resume(totals, tmp, host)
        del host
        hier_card_vs_cpu(totals, tmp)
        emit({"phase": "hier_total",
              "seconds": time.perf_counter() - t_hier})

    # the (clients, model) mesh: 4 and 2 gloo ranks on the one card, beside
    # the auto ranks too (the MoE arm made those longer than the robust
    # and hier_* phases)
    with tempfile.TemporaryDirectory() as tmp:
        fl_sharded_mesh_card(totals, tmp)
    autos = [fl_sharded_auto_finish(
        totals, rec_run, beside="the robust phases (fcn_topk_signflip_gm "
                                "to fcn_buffered_straggler), hier_*, "
                                "fl_sharded_mesh_card")]
    shutil.rmtree(rec_tmp, ignore_errors=True)

    # the card-vs-CPU phases' CPU sides, in a worker process beside the
    # LM phases (the heaviest first); their card sides run last
    cpu_dir = tempfile.mkdtemp(prefix="chip_smoke_cpu_")
    worker = CpuWorker(
        [("train", f"train-{a}", {"arch": a, "T": T})
         for a, T in TRAIN_CARD_CPU_T.items()]
        + [("fl", f"fl-{a}", {"arch": a, "K": 2, "T": 256, "rounds": 2})
           for a in LM_KERNEL], cpu_dir)
    try:
        lm_phases(totals)
        lm_card_vs_cpu()
        pca_cnn()
        # LBGM federated rounds of the LMs through the engine, full width;
        # the card-vs-CPU card sides' host draws on a thread beside them
        draws = concurrent.futures.ThreadPoolExecutor(1)
        train_in = {a: draws.submit(train_cpu_inputs, a, T, 2, 1)
                    for a, T in TRAIN_CARD_CPU_T.items()}
        fl_in = {a: draws.submit(fl_cvc_inputs, a, 2, 256, 2)
                 for a in LM_KERNEL}
        fl_lm_qwen3_dense()
        # the in-memory run is the reference of the topk-host and the
        # sharded phases
        inmem, state = fl_lm_topk(
            "fl_lm_qwen3_topk_int8", "qwen3-1.7b", keep_state=True,
            **{"fl.chunk_size": 2, "fl.codec": "int8", "rounds": 2})
        fl_lm_qwen3_topk_host(totals, inmem)
        fl_sharded_qwen3_topk(totals, inmem, state)
        del inmem, state
        fl_lm_topk("fl_lm_rwkv6_topk", "rwkv6-3b",
                   **{"fl.num_clients": 2, "data.kw.n": 2, "rounds": 2})
        # fl_sharded_auto_card: its (1, 1) reference here, then its 2
        # ranks beside the buffered phase and the card-vs-CPU phases' card
        # sides (checks whose times are not cells; beside the card-vs-CPU
        # phases alone this process waited 42 s for them on a slow host,
        # and fl_lm_rwkv6_topk's 53.5 GB peak leaves no room for them)
        auto_tmp = tempfile.mkdtemp(prefix="chip_smoke_auto_")
        auto_run = fl_sharded_auto_start(auto_tmp)
        fl_lm_qwen3_buffered_scalar_median()
        # every training LM and both FL-LMs against the CPU in fp32
        lm_train_card_vs_cpu(worker, train_in)
        fl_lm_card_vs_cpu(worker, fl_in)
        autos.append(fl_sharded_auto_finish(
            totals, auto_run, beside="fl_lm_qwen3_buffered_scalar_median, "
                                     "lm_train_card_vs_cpu, "
                                     "fl_lm_card_vs_cpu"))
        shutil.rmtree(auto_tmp, ignore_errors=True)
        draws.shutdown()
    finally:
        worker.close()
        shutil.rmtree(cpu_dir, ignore_errors=True)

    flash_single_bf16_p()

    # the auto phases' launch shapes: flash and the scan at a model rank's
    # local heads and the decision at each model rank's rows
    for recs, errs in autos:
        for k in kernels:
            name = k["name"]
            if recs.get(name):
                k.setdefault("shapes", []).extend(recs[name])
                k["max_abs_err"] = max(k["max_abs_err"],
                                       errs.get(name, 0.0))
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    for name, rec in TRAIN_SHAPE_RECORDS:
        entry = next(k for k in kernels if k["name"] == name)
        entry["shapes"].append(dict(rec, launches_per="training step"))
    for k in kernels:
        k["launches"] = totals[k["name"]]
        for rec in k.get("shapes", []):
            shp = rec["shape"]
            key = tuple(tuple(x) for x in shp) if isinstance(shp[0], list) \
                else tuple(shp)
            counts = TRAIN_SHAPES if rec.get("launches_per") else SHAPE_TOTALS
            rec["launches"] = counts.get(k["name"], {}).get(key, 0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
