#!/usr/bin/env python3
"""Smoke run of hymet_tpu_torch on one NVIDIA card (H100).

    python3 chip_smoke.py [--seed N] [--only distributed|bench|profile]

Phases, each printed as one JSON line with its seconds:

1. device  — requires CUDA; the card's name, power limit, SM count and
             largest SM clock.
2. build   — nvcc builds the hand-written kernels from the checkout's
             sources; prints ptxas's registers, shared memory and spills.
             The host compiler builds the CPU path's native helpers
             (``io/native_io.py``), held against the numpy versions on the
             gut contigs (encode, hashes at k = 21, minimizers at k = 19,
             w = 19): equality and seconds, host code.
3. kernel  — every kernel against its plain PyTorch version on the card:
             ``kmer_hashes`` bit for bit and ``screen_count`` count for
             count (counts and valid-window total), at the edge cases (k at
             Murmur's block and tail boundaries, lengths around a thread's
             run of windows and not a multiple of 4, 8 or 16, N runs on run
             boundaries, an all-padding row, every window or none past the
             threshold, one key), ``kmer_hashes`` at the chunked screen's
             shape and ``screen_count`` on each batch of the staged gut
             screen; each kernel's time, its plain version's time and its
             bound (see :func:`window_ops`), ``screen_count`` summed over
             one staged screen, with the survivors of the threshold; and
             ``bottom_sketch`` bit for bit on :func:`bottom_sketch_edge_sets`
             (s = 1, 7, 1000 and above a wave and the windows; poly-A;
             duplicates across waves; an all-invalid row; a real PAD_HASH;
             wave and chunk edges; pooled segments; descending keys; ties at
             the s-th key; a sparse first chunk) and ``sketch_codes`` on
             :func:`sketch_codes_edge_sets` (s = 1 .. 10,000 and above the
             windows; poly-A, repeat, all-N and half-N rows; wave and chunk
             edges; one row much longer; k = 15, 21, 31).
4. slice   — contigs -> staged upload -> sketch screen -> candidate limit
             on the in-repo synthetic CAMI world (validation/work_cami_suite:
             sketch1-3 and the camisyn_gut contigs), three times: with the
             kernel, with the plain count (ScreenEngine's ``count_fn``
             default swapped), and through the chunked path. All screen files
             must be byte-identical across the three, ``screen_count`` must
             have been launched on the staged and chunked runs, and
             ``kmer_hashes`` on none (the main path does not go through it).
             Then one more staged screen under torch.profiler, with every
             device activity.
5. scale   — the same screen against a RefSeq-sized merged DB: sketch1-3
             plus 100,000 synthetic references x 1000 hashes made on the
             card from --seed (1e8 flat hashes); median of 3 screen-stage
             runs, the kernel's share of it, peak device memory, and one
             profiled run (device busy time and idle share).

6. align   — the align slice on the same staged gut batches: the screen
             selects genomes, their FASTAs (validation/work_cami_suite/
             genomes/, in selected_genomes.txt order) make the reference,
             and ``run_align_stage`` builds its minimizer index on the card
             and writes ``resultados.paf``; with every launch count set to 0
             just before and read just after, each of ``minimizers``,
             ``anchors`` and ``chains`` must have been launched. The same
             stage with the plain versions (MinimizerAligner's ``ops``
             default swapped) must write the same bytes, and the card's index
             equal the numpy twin's on the first 5 Mbp or more of the
             reference. Then the index build's seconds, ``map_batch``'s
             (median of 3), the record count, peak device memory, the
             overflow boosts and one profiled ``map_batch``, which must run
             no torch sort or gather kernel (its anchors come sorted from
             the ``anchors`` kernel); its ``minimizers`` kernels, and the
             device activities of one ``minimizers`` call (at most 3: the
             tile kernel, the tail fill and the memset of the status words)
             and of one ``anchors`` call (at most ``SortLayout.launches``:
             search, scan, expansion, and a scatter a sort pass).
7. align kernels — ``minimizers``, ``anchors`` and ``chains`` against their
             plain versions bit for bit, on the 16 staged gut batches (the
             main path's shapes, with that index) and at the edge cases
             (N runs, padded, short and all-padding rows, a row shorter than
             k + w, k and w at their limits, repeats with equal hashes in a
             window, a repetitive index and caps that overflow),
             ``anchors`` on the worlds at its search's and sort's edges
             (:func:`anchor_edge_sets`, at two acaps), and
             ``chains`` on the synthetic sets at its tile edges
             (:func:`chain_edge_sets`), ``minimizers`` on the code batches
             at its tile edges (:func:`minimizer_edge_sets`, with and
             without row lengths, 20 calls of one giving one answer);
             each kernel's time, its plain version's and its bound (see
             :func:`minimizer_ops`, :func:`anchor_bound_ms`), summed over
             one pass of the batches, ``anchors``' library yardstick
             (``torch.sort`` of the filled prefix and its two gathers), the
             bucket table and each batch's search loads and longest chain;
             and ``minimizers`` on the
             index build's batches with their row lengths (the
             ``index_pass``: held bit for bit, timed, bounded).

8. run     — the whole run as a user calls it: ``ClassificationRun.execute``
             on the gut sample (sketch1-3, the in-repo genomes, acc2taxid.tsv
             and taxonomy, RunConfig defaults; cache and outputs in the
             temporary directory), with every launch count set to 0 just
             before and read just after: each stage's seconds, each kernel's
             launches (all but ``kmer_hashes`` must be launched, ``lca``
             included), the first-hit fallback must not have run, and
             ``classified_sequences.tsv`` must be byte-identical to a CPU
             re-classification of the run's own ``resultados.paf``; the
             classified rows, the LCA's bucket batches, and one profiled
             classification (device busy and idle share).
9. lca     — ``weighted_lca``'s kernel against ``weighted_lca_torch``, bit
             for bit (names, depths, float64 confidence bits), on
             :func:`lca_edge_sets` at H = 8 .. 2048 (two seeds: ties on
             purpose, -1 rows, all-zero rank rows, no name at rank 0) and on
             the gut classification's batches; its time over those batches,
             its plain version's, its bound (:func:`lca_bound_ms`) and its
             share of the classify stage.
10. db      — the user's command line: ``hymet_tpu_torch.cli.main(["sketch",
             ...])`` rebuilds sketch1-3 on the card from
             validation/work_cami_suite/genomes/ (each DB's files in its
             committed rows' order; 234 genomes, k = 21, s = 1000), as
             ``.npz`` and as ``.msh``, with every launch count set to 0
             just before and read just after: ``sketch_codes`` must be
             launched, and neither ``kmer_hash`` nor ``bottom_sketch``, and
             both files must equal the committed sketch{1,2,3}.npz bit for
             bit (hashes, n_hashes, lengths, names). Six genomes of sketch1 built again
             under a window budget that puts each up in pieces must launch
             ``bottom_sketch`` (the fold) and equal their committed rows.
             Then each DB's build split (gunzip + parse + encode, upload,
             sketch_codes) and peak device memory, and on each build's
             batches ``sketch_codes`` and the earlier route's two kernels
             (``kmer_hash``, then ``bottom_sketch`` on its hashes) against
             their plain versions bit for bit, timed with their bounds and,
             for ``bottom_sketch``, the library call ``torch.unique``.
             Then ``cli.main(["run", ...])`` with the three ``.msh`` DBs
             on phase 8's cache must write phase 8's
             ``classified_sequences.tsv`` and CAMI profile byte for byte,
             through every kernel of the run; and ``cli.main(["legacy",
             ...])`` on the same cache must write the legacy classifier's
             TSV of its own PAF.
11. eval    — the evaluator as a user calls it, on phase 8's run of the gut
             sample: ``cli.main(["eval", ...])`` with its CAMI profile,
             ``classified_sequences.tsv``, ``resultados.paf`` and the
             cache's ``detailed_taxonomy.tsv`` against the committed truth
             (contigs paired by name: no aligner kernel may be launched);
             then against a second assembly of the sample made in the
             temporary directory (:func:`second_assembly`: all 1000 contigs
             renamed, odd ones reverse-complemented, even ones cut at both
             ends), where names and MD5s pair nothing and the contig remap
             builds a 1000-contig truth index on the card and maps the 1000
             contigs unstaged, with every launch count set to 0 just before
             and read just after: ``minimizers`` at least once a map group
             and an index batch, ``anchors`` and ``chains`` once a group;
             every pair the contig's own counterpart; ``contigs_exact.tsv``
             and ``contigs_per_rank.tsv`` byte-identical to the same remap
             with the plain versions (MinimizerAligner's ``ops`` default
             swapped); the pair count and the remap's seconds (index build,
             map, the rest). Then ``testdataset`` on the in-repo genomes and
             ``subset`` of the gut contigs, with their counts (host code).
12. harness — the experiment harnesses as a user calls them, on the card,
             with a cold cache of their own: ``cli.main(["bench", ...])`` on a
             manifest of the three in-repo CAMI samples (gut, marine,
             strainmadness, with their truth files), every launch count set
             to 0 just before each sample's run and read just after
             (``screen_count``, ``minimizers``, ``anchors``, ``chains`` and
             ``lca`` each launched; no first-hit fallback); each sample's
             files, runtime rows and aggregate tables; each TSV equal to a
             CPU re-classification of its own PAF, and gut's ``eval/`` equal
             to ``evaluate(..., device="cpu")`` on the same inputs; then
             ``run`` on gut at the bench's settings (``--cand-max 1500
             --species-dedup``, the bench's cache) writing the bench's gut
             files byte for byte. ``case`` on gut against the bench's gut
             profile (KL 0, Spearman 1). ``ablation`` of the bench's cached
             gut reference (216 genomes) at levels 0.0 and 1.0 of the three
             taxa with the most gut contigs: each level's run launches
             ``minimizers``, ``anchors``, ``chains`` and ``lca`` and not
             ``screen_count`` (a preset reference: no screen), and its TSV
             equals a CPU re-classification of its PAF. ``truth build-zymo``
             on the bench's gut PAF (host code: equal to ``build_zymo_truth``
             under ``HYMET_PLATFORM=cpu``) and ``fetch`` of ``file://`` URLs.
             The bench and the ablation catch a run's failure and go on, as
             the JAX harness does, so the phase decides from files and
             launch counts, never from an exit code alone.
13. sharded — the reference sharded over a 2 x 4 ("data", "db") mesh of
             the card named eight times (the counterpart of XLA's virtual
             devices): (a) ``sharded_topk`` on the card equal to the CPU's
             (65,536 scores with ties, k = 1 .. all); (b) the chunked
             ``ShardedScreenEngine`` screen of the gut contigs against
             merged sketch1-3 with every launch count set to 0 just before
             and read just after: identity, shared, median and the window
             total equal to the single-device ``ScreenEngine``'s on the
             staged batches and to the plain count's, and ``screen_count``
             launched once a batch and shard; (c) ``ClassificationRun
             .execute`` on the gut sample at ``db_shards = 4`` with
             ``mesh_devices`` the card eight times and a cold cache, its
             counts set to 0 just before and read just after:
             ``selected_genomes.txt`` equal to phase 8's, and the PAF and
             the classified TSV equal to a re-run of its align stage
             (``ShardedMinimizerAligner`` with the plain versions, all 1000
             contigs) classified on the CPU; (d) the stage split and each
             shard's launches (counted inside ``ScreenEngine.update_staged``
             and ``MinimizerAligner._dispatch_fused``): every screen shard
             launched ``screen_count``, every index shard ``minimizers``,
             ``anchors`` and ``chains`` at least once a group of 64
             contigs; (e) as a fact, not a gate, how many classified rows
             differ from phase 8's single-device run (``max_occ`` applies to
             each shard's index alone). Then the sharded ``map_batch`` of
             the 1000 contigs and the one-device one (unstaged, the same
             index): 3 timed runs each and one trace (device busy, idle).
14. distributed — phase 13's run over processes: 2 ``torch.distributed``
             gloo processes on the card, each naming it twice (a global
             1 x 4 mesh; one process a card, 4 processes, where 4 cards are
             visible), started with ``sys.executable`` after this process
             built the kernels, each running ``execute`` on the gut sample
             at ``db_shards = 4`` with a cold cache, its counts set to 0
             just before and read just after. Process 0's selected genomes,
             PAF, classification and CAMI profile must equal phase 13's
             byte for byte, every other process's must equal them under
             its ``.proc<i>`` paths, which are all it writes; each process
             must launch ``screen_count`` once a chunked batch on each of
             its own shards and on no other, ``minimizers``, ``anchors``
             and ``chains`` at least once a group of 64 contigs on each of
             its index shards, and ``lca``. Prints each process's seconds,
             stage split and launches. A worker that fails or outlasts
             ``DIST_TIMEOUT_S`` fails the phase; every worker is stopped.

15. bench   — the port's bench (``python -m hymet_tpu_torch.bench``), on a
             seeded synthetic stand-in for the Zymo panel it reads
             (:func:`synthetic_panel`: 24 genomes of 1-3 Mbp, about 48 Mbp,
             in a temporary directory; the panel is in neither the
             repository nor the card's machine). ``sketch_batch_topk`` with
             the ``kmer_hashes`` kernel against the same selection over the
             plain hash, element for element, and the two
             ``finish_bottom_sketch`` results and warnings equal, on
             :func:`topk_edge_sets` and on the sketch mode's first [8, 2 Mbp]
             chunk (with both functions' times there). Then every mode in
             this process at the bench's sizes (sketch: 32 x 2 Mbp refs,
             8 x 1 Mbp batches; sketch_large: 100,000 x 1000 hashes; align:
             [64, 65,536] batches; pipeline: BENCH_CONTIGS = 1000), each
             with a cold cache under the temporary directory and every
             launch count set to 0 just before and read just after: the
             sketch DB build's ``kmer_hashes`` once a ``sketch_batch_topk``
             call (4), ``screen_count`` once an ``update_codes``, ``anchors``
             and ``chains`` once an aligner dispatch, every kernel of the
             run (``lca`` included) in each pipeline run, and no kernel
             outside the mode's. The sketch mode's DB must equal
             ``sketch_codes`` of the same 32 references, the pipeline's
             last TSV a CPU re-classification of its PAF, with a species
             accuracy of at least 0.9. Last, one child ``python -m
             hymet_tpu_torch.bench`` in sketch mode must exit 0 with exactly
             one JSON line (the watchdog silent).

16. profile — (run after phase 9) phase 8's run again under
             ``HYMET_PROFILE=1`` (the run's per-stage torch.profiler
             traces), in a fresh outdir with a cold cache, so that the align
             stage builds its index on the card; every launch count set to
             0 just before, and each stage's launches read around it. Each
             stage's gzipped Chrome trace (path, bytes); each stage's trace
             must show every launch of its kernels (``screen_count`` in
             screen; ``minimizers``, ``anchors``, ``chains`` in align, the
             index build's ``minimizers`` too; ``lca`` in classify): the
             activities of the kernel each wrapper call launches once equal
             the wrapper's count in that stage, and no kernel is launched
             outside a stage. The selected genomes, PAF, classification and
             CAMI files must equal phase 8's. Prints the run's seconds and
             stage split with the profiler and phase 8's without it, and the
             card's name and power limit.

``--only distributed`` runs phases 1 and 2, phase 13's run at
``db_shards = 4`` alone, and phase 14 (for a call on four cards);
``--only bench`` runs phases 1, 2 and 15; ``--only profile`` phases 1, 2,
8 and 16. Each ends with the seconds and the nvidia-smi line and prints
neither the kernels line nor the ``{"ok": true, ...}`` line.

Then the script's seconds (phase "total"), the card's name and power
limit as nvidia-smi prints them, one JSON line with the kernels' numbers
(``sharded_launches``: phase 13's run; ``distributed_launches``: phase
14's, a process each; ``bench_launches``: phase 15's, a mode each;
``profile_launches`` and ``profile_traced``: phase 16's launches in the
profiled run's stages and the activities their traces show; for
``kmer_hash``, ``launches`` is the bench's sketch DB build), and as the
last line
``{"ok": true, "device": {...}}``. Any failure raises (non-zero exit).
Outputs go to a temporary directory outside the repository.
"""

from __future__ import annotations

import argparse
import filecmp
import glob
import gzip
import hashlib
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch

from hymet_tpu_torch import bench, cli
from hymet_tpu_torch.evalx import eval_cami
from hymet_tpu_torch.harness import zymo_truth
from hymet_tpu_torch.io import native_io, sketchdb
from hymet_tpu_torch.io.fasta import encode_seq, iter_fasta, pack_code_batch, read_fasta
from hymet_tpu_torch.io.minimizer_index import MinimizerIndex, _row_batches
from hymet_tpu_torch.io.paf import parse_paf_for_classification, write_paf
from hymet_tpu_torch.io.sketchdb import SketchDB, build_sketch_db, load_sketch_db
from hymet_tpu_torch.models.legacy_lca import classify_paf_legacy
from hymet_tpu_torch.models.aligner import AlignerConfig, MinimizerAligner, plan_query_groups
from hymet_tpu_torch.models.weighted_lca import (
    classify_paf,
    lca_inputs,
    load_hierarchy_vectors,
    taxid_weights,
)
from hymet_tpu_torch.ops import align_kernels, hash_kernels, lca, sketch_kernels
from hymet_tpu_torch.ops.hash_kernels import count_hashes, screen_count_torch
from hymet_tpu_torch.ops.hashing import SIGN, kmer_hashes_numpy, kmer_hashes_torch, unpack_code_batch
from hymet_tpu_torch.ops.minimizer import extract_minimizers_numpy, extract_minimizers_torch
from hymet_tpu_torch.ops.sketch import (
    ScreenEngine,
    finish_bottom_sketch,
    flat_index_device,
    sketch_batch_topk,
)
from hymet_tpu_torch.parallel import make_mesh, sharded_topk
from hymet_tpu_torch.parallel.align import ShardedMinimizerAligner
from hymet_tpu_torch.parallel.distributed import init_distributed, local_card, shutdown
from hymet_tpu_torch.parallel.screen import ShardedScreenEngine
from hymet_tpu_torch.pipeline.align_stage import run_align_stage
from hymet_tpu_torch.pipeline.candidates import limit_candidates_files
from hymet_tpu_torch.pipeline.run import ClassificationRun
from hymet_tpu_torch.pipeline.screen_stage import run_screen_stage, stream_screen
from hymet_tpu_torch.pipeline.staged import StagedContigs
from hymet_tpu_torch.taxonomy.idmap import IdentifierMap
from hymet_tpu_torch.utils.config import RunConfig

REPO = os.path.dirname(os.path.abspath(__file__))
WORLD = os.path.join(REPO, "validation", "work_cami_suite")
GUT = os.path.join(WORLD, "data", "camisyn_gut")
CONTIGS = os.path.join(GUT, "contigs.fna")
GENOMES = os.path.join(WORLD, "genomes")
DB_LABELS = ["sketch1", "sketch2", "sketch3"]
# The DB build's kernels, not the run's: sketch_codes on every batch,
# bottom_sketch on the pieces of a genome past the window budget. A run
# launches neither, nor kmer_hash (the Pallas kernel's standalone
# counterpart, which only the bench's sketch DB build calls).
DB_BUILD_KERNELS = ("sketch_codes", "bottom_sketch")
RUN_IDLE = ("kmer_hash", *DB_BUILD_KERNELS)

# H100 SXM memory rate (NVIDIA data sheet) and 32-bit integer issue rates
# per SM and clock (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0): add, compare, shift and logic 64;
# multiply-add 64, on the FMA pipe beside the integer ALU; and at most one
# warp instruction per scheduler and clock, 4 x 32 = 128. The card has no
# 64-bit integer unit, so 64-bit work is counted in 32-bit instructions.
PEAK_BYTES_S = 3.35e12
ALU_PER_CLK, MAD_PER_CLK, ISSUE_PER_CLK = 64, 64, 128
# float64 add, multiply and multiply-add results per SM and clock (the same
# table, compute capability 9.0)
FP64_PER_CLK = 64

# The screen's chunk shape (RunConfig.screen_chunk_bp rows, 8 at a time).
MAIN_B, MAIN_L, MAIN_K = 8, 1 << 20, 21
# CUDA kernel names of the device passes screen_count fused: the unpack's
# torch.stack, the standalone hash kernel, searchsorted, index_add_
PASSES_FUSED = ("CatArrayBatchedCopy", "kmer_hash_kernel", "searchsorted", "indexFuncLargeIndex",
                "indexFuncSmallIndex")
# k at Murmur's block and tail boundaries; windows a thread owns in the
# kernels (csrc/kmer_core.cuh kRun)
EDGE_K = (15, 16, 17, 21, 24, 25, 32)
RUN = 16


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3), **fields}), flush=True)


def window_ops(k: int, screen: bool) -> tuple:
    """(ALU, multiply-add) 32-bit instructions the function needs per window,
    counted from the function, not from a kernel's way of computing it.
    A 64-bit add, logic op or shift counts 2, a 64-bit multiply by a
    constant 3 (multiply-adds), a 64-bit compare or select 2:

    - validity of the window: 1 (a bit test; the AND over k mask bits is
      shared by a thread's run of 16 windows);
    - the canonical 2-bit k-mer: the forward and reverse-complement words
      4 each (a 64-bit shift out of the run's codes and a mask), their
      compare 2: 10;
    - the canonical string's ASCII words, ceil(k/8) of them: per word a
      32-bit funnel shift per half for each of the two strings (4), the
      select (2); the mask of the bytes past k (2); each new base's letter
      in the forward and the reverse-complement string (2);
    - per 16-byte Murmur block: ALU 16 (two rotates, two XORs into h, two
      rotates of h, the two adds h1 += h2 and h2 += h1), multiply-adds 16
      (k1 and k2 times a constant twice each, 3 each; ``h * 5 + c`` for h1
      and h2, 2 each, the wide multiply-add taking the 64-bit constant as
      its addend);
    - per tail word (k & 15 > 0, and > 8): ALU 4, multiply-adds 6;
    - finalisation: ALU 20 (the XOR of the 32-bit length into h1 and h2,
      1 each; the two adds, 2 each; three shift-XORs ``h ^= h >> 33`` in
      each fmix, 2 each, as the shifted word's high half is zero; the
      final add, 2), multiply-adds 12 (two per fmix);
    - the survivor filter of ``screen_count``: 3 (sign flip of the high
      word and a 64-bit compare); for ``kmer_hashes`` instead the packing
      of each code byte to 2 bits and its validity bit: 2.
    """
    nw = -(-k // 8)
    nblocks, tail = divmod(k, 16)
    alu = 1 + 10 + (6 * nw + 2) + 2 + 16 * nblocks + 4 * (tail > 8) + 4 * (tail > 0) + 20
    mad = 16 * nblocks + 6 * (tail > 8) + 6 * (tail > 0) + 12
    return alu + (3 if screen else 2), mad


def ops_ms(alu: float, mad: float, sms: int, clock_hz: float) -> float:
    """Least time in ms for `alu` ALU and `mad` multiply-add instructions
    spread over `sms` SMs at `clock_hz`."""
    clocks = max(alu / ALU_PER_CLK, mad / MAD_PER_CLK, (alu + mad) / ISSUE_PER_CLK)
    return clocks / sms / clock_hz * 1e3


def hash_bound_ms(shapes, k: int, sms: int, clock_hz: float) -> tuple:
    """(least time in ms, what bounds it) for ``kmer_hashes`` over [B, L]
    batches of the given shapes: every window is hashed (each is written);
    each code read once, each hash (8 B) and valid flag (1 B) written once."""
    n = sum(B * (L - k + 1) for B, L in shapes)
    t_bytes = (sum(B * L for B, L in shapes) + 9 * n) / PEAK_BYTES_S * 1e3
    alu, mad = window_ops(k, screen=False)
    t_ops = ops_ms(n * alu, n * mad, sms, clock_hz)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def screen_bound_ms(batches, k: int, sms: int, clock_hz: float) -> tuple:
    """(least time in ms, what bounds it) for ``screen_count`` over batches
    given as (input bytes, valid windows, survivors, F): the function is
    counted only on the valid windows (nothing for positions the mask marks
    as padding or invalid); packed and mask bytes read once, per survivor
    one 8-byte key read and one 4-byte count written, and a binary search of
    ceil(log2 F) steps of 6 ALU instructions."""
    alu, mad = window_ops(k, screen=True)
    nbytes = sum(b + 12 * s for b, _, s, _ in batches)
    n_alu = sum(v * alu + s * 6 * max(1, math.ceil(math.log2(F))) for _, v, s, F in batches)
    n_mad = sum(v * mad for _, v, _, _ in batches)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops_ms(n_alu, n_mad, sms, clock_hz)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA
    events). The card first sleeps, per call, twice the host's time to
    enqueue one (the fastest warm-up call; at least 50 us, at most 2 ms at
    2 GHz), so that the host has enqueued the calls before they run: a
    kernel shorter than its wrapper's host time is timed, not the host."""
    host_s = math.inf
    for _ in range(warmup):
        t = time.perf_counter()
        fn()
        host_s = min(host_s, time.perf_counter() - t)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(max(100_000, 2 * host_s * 2e9), 4_000_000)) * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# traces of one run at most; a lost trace is retaken after a pause, as the
# H100's losses came in runs of consecutive traces
PROFILE_ATTEMPTS = 6
PROFILE_PAUSE_S = 2.0
# `lost` for a trace whose checks hold with any loss of a counted kernel
# that still shows once
ANY_LOST = 2**31


def profile_run(fn, counted=(), lost: int = 0) -> dict:
    """One run of fn() under torch.profiler: its wall time, the device's
    busy time (CUDA kernels and copies, all on one stream), the idle
    share, and every device activity (name, ms, count), longest first.

    `counted`: (wrapper, kernel name) pairs, each wrapper launching its
    kernel at least once where it adds one to its count. A trace that
    shows more than `lost` fewer of a kernel than its wrapper counted in
    the run, or none of it, has lost device activity beyond what the
    caller's checks allow, so fn() runs again under a new trace, at most
    PROFILE_ATTEMPTS times in all, PROFILE_PAUSE_S apart; no whole trace
    raises. On the H100 the profiler loses a trace's first device records
    and drops those stamped before the trace's start (PERF.md §6): 14 or
    15 of a map_batch's 16 ``minimizers`` launches showed in each of three
    traces (its callers pass ANY_LOST), one of 8 lone calls in most traces
    of 8 (the per-call traces pass 1), and once none of a staged screen's
    16 ``screen_count`` launches. The run's HYMET_PROFILE traces open with
    a lead that takes those losses (``pipeline/run.profile_lead``); these
    do not, as its copies would count among fn()'s activities. `launches`
    gives each kernel's count in the kept run, `traced` the launches its
    trace shows, and `lost_traces` the traces thrown away, as [name,
    counted, traced] lists."""
    from torch.profiler import ProfilerActivity, profile

    thrown = []
    for _attempt in range(PROFILE_ATTEMPTS):
        before = [wrapper.launches for wrapper, _name in counted]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        launches = {name: wrapper.launches - b for (wrapper, name), b in zip(counted, before)}
        traced = {name: sum(e.count for e in rows if name in e.key) for name in launches}
        short = [[name, n, traced[name]] for name, n in launches.items()
                 if traced[name] < max(min(n, 1), n - lost)]
        if not short:
            break
        thrown.append(short)
        print(f"chip_smoke: the trace lost device activity {short}, tracing again",
              file=sys.stderr)
        time.sleep(PROFILE_PAUSE_S)
    else:
        raise AssertionError(f"torch.profiler lost device activity in {PROFILE_ATTEMPTS} traces: "
                             f"{thrown}")
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    rows = sorted(rows, key=lambda e: -e.self_device_time_total)
    return {"wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
            "device_ms": [[e.key[:90], e.self_device_time_total / 1e3, e.count] for e in rows],
            "launches": launches, "traced": traced, "lost_traces": thrown}


def codes_with_n_runs(rng: np.random.Generator, B: int, L: int) -> np.ndarray:
    """Random ACGT codes with runs of N (code 4) and an N tail on row 0."""
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    for b in range(B):
        for _ in range(max(1, L // 50_000)):
            start = int(rng.integers(0, L))
            codes[b, start : start + int(rng.integers(1, 200))] = 4
    codes[0, -(L // 10 or 1) :] = 4
    return codes


def edge_codes(rng: np.random.Generator, L: int) -> np.ndarray:
    """[3, L] codes: N runs, N bases on the last base of a thread's run of
    windows and on the first base of the next (row 1), and an all-padding
    row 2."""
    codes = codes_with_n_runs(rng, 3, L)
    codes[1, RUN - 1 :: 3 * RUN] = 4
    codes[1, 2 * RUN :: 3 * RUN] = 4
    codes[2] = 4
    return codes


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check_kernel(codes: torch.Tensor, k: int) -> float:
    """Raise unless the kernel's hash and valid equal the plain version's
    bit for bit; returns the largest absolute difference (0.0)."""
    h, v = hash_kernels.kmer_hashes(codes, k)
    h_ref, v_ref = kmer_hashes_torch(codes, k)
    torch.cuda.synchronize()
    if not (torch.equal(h, h_ref) and torch.equal(v, v_ref)):
        raise AssertionError(f"kmer_hash kernel differs from the plain version at k={k}, shape={list(codes.shape)}")
    return float((h.double() - h_ref.double()).abs().max())


def new_counts(F: int) -> tuple:
    return (torch.zeros(F, dtype=torch.int32, device="cuda"),
            torch.zeros(1, dtype=torch.int64, device="cuda"))


def check_count(packed, mask, L: int, k: int, flat, t: int) -> tuple:
    """Raise unless screen_count's counts and valid total equal the plain
    version's element for element; returns (largest absolute difference
    (0.0), valid windows, hits)."""
    got, want = new_counts(flat.shape[0]), new_counts(flat.shape[0])
    hash_kernels.screen_count(packed, mask, L, k, flat, t, *got)
    screen_count_torch(packed, mask, L, k, flat, t, *want)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(
            f"screen_count kernel differs from the plain version at k={k}, L={L}, "
            f"shape={list(packed.shape)}, F={flat.shape[0]}, t={t}"
        )
    err = max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
    return err, int(want[1]), int(want[0].sum())


def survivors(packed, mask, L: int, k: int, t: int) -> int:
    """The valid windows of a batch whose key is <= t."""
    h, v = kmer_hashes_torch(unpack_code_batch(packed, mask, L), k)
    return int((v & ((h ^ SIGN) <= t)).sum())


def two_pass(packed, mask, L: int, k: int, flat, t: int, counts, total) -> None:
    """screen_count's function the way the screen ran it before the kernel
    fused it: unpack, the hash kernel, then the filter, searchsorted and
    index_add_ as separate device passes."""
    h, valid = hash_kernels.kmer_hashes(unpack_code_batch(packed, mask, L), k)
    count_hashes(h, valid, flat, t, counts, total)


def edge_keys(rng: np.random.Generator, packed, mask, L: int, k: int) -> list:
    """(flat, t) cases for a batch: keys holding a sample of its valid
    windows' keys plus two random ones, with t = the largest key, t at the
    sign-flipped maximum (every valid window survives), t below every key
    (none survives); and a single key that is one of the batch's (F = 1)."""
    h, v = kmer_hashes_torch(unpack_code_batch(packed, mask, L), k)
    q = (h[v] ^ SIGN).cpu().numpy()
    extra = rng.integers(-(2**63), 2**63 - 1, 2, dtype=np.int64)
    pick = q[rng.choice(q.size, min(q.size, 40), replace=False)] if q.size else q
    flat = torch.from_numpy(np.unique(np.concatenate([pick, extra]))).cuda()
    cases = [(flat, int(flat[-1])), (flat, 2**63 - 1), (flat, -(2**63))]
    if q.size:
        one = torch.from_numpy(q[:1].copy()).cuda()
        cases.append((one, int(one[0])))
    return cases


def phase_kernel(seed: int, cfg: RunConfig, sms: int, clock_hz: float) -> dict:
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    cases, max_err = {"kmer_hash": [], "screen_count": []}, {"kmer_hash": 0.0, "screen_count": 0.0}
    for k in EDGE_K:
        for L in (k, k + 1, RUN + k - 1, RUN + k, 1003, 4096 + k + 5):
            codes = edge_codes(rng, L)
            max_err["kmer_hash"] = max(max_err["kmer_hash"], check_kernel(torch.from_numpy(codes).cuda(), k))
            cases["kmer_hash"].append([k, *codes.shape])
            packed, mask, _ = pack_code_batch(codes)
            packed, mask = torch.from_numpy(packed).cuda(), torch.from_numpy(mask).cuda()
            for flat, t in edge_keys(rng, packed, mask, L, k):
                err, _, hits = check_count(packed, mask, L, k, flat, t)
                max_err["screen_count"] = max(max_err["screen_count"], err)
                cases["screen_count"].append([k, *codes.shape, int(flat.shape[0]), t, hits])
    for k in (15, MAIN_K, 32):
        codes = torch.from_numpy(codes_with_n_runs(rng, MAIN_B, MAIN_L)).cuda()
        max_err["kmer_hash"] = max(max_err["kmer_hash"], check_kernel(codes, k))
        cases["kmer_hash"].append([k, MAIN_B, MAIN_L])
    hash_ms = cuda_ms(lambda: hash_kernels.kmer_hashes(codes, MAIN_K))
    hash_plain_ms = cuda_ms(lambda: kmer_hashes_torch(codes, MAIN_K), iters=20, warmup=1)
    hash_bound, hash_by = hash_bound_ms([(MAIN_B, MAIN_L)], MAIN_K, sms, clock_hz)
    del codes
    # the staged screen's own batches (the main path's shapes): each one
    # checked count for count; kernel, plain version, the earlier two-pass
    # path and the bound summed over one screen's launches
    staged, dbs = stage_contigs(cfg), load_world_dbs()
    flat = flat_index_device(SketchDB.concat(dbs).hashes, torch.device("cuda"))[0]
    k, t = dbs[0].k, int(flat[-1])
    # where the kernel's time goes: the same launches with no survivor (t
    # below every key) and with every position marked padding
    screen = {"ms": 0.0, "plain_ms": 0.0, "two_pass_ms": 0.0, "no_survivor_ms": 0.0,
              "padding_only_ms": 0.0, "positions": 0}
    batches, shapes = [], []
    for packed, mask, _rows, L in staged.device:
        err, valid, hits = check_count(packed, mask, L, k, flat, t)
        max_err["screen_count"] = max(max_err["screen_count"], err)
        surv = survivors(packed, mask, L, k, t)
        batches.append((packed.numel() + mask.numel(), valid, surv, int(flat.shape[0])))
        shapes.append([*packed.shape, L, valid, surv, hits])
        screen["positions"] += 4 * packed.numel()
        scratch = new_counts(flat.shape[0])
        screen["ms"] += cuda_ms(lambda: hash_kernels.screen_count(packed, mask, L, k, flat, t, *scratch))
        screen["no_survivor_ms"] += cuda_ms(
            lambda: hash_kernels.screen_count(packed, mask, L, k, flat, -(2**63), *scratch))
        padding = torch.zeros_like(mask)
        screen["padding_only_ms"] += cuda_ms(
            lambda: hash_kernels.screen_count(packed, padding, L, k, flat, t, *scratch))
        screen["plain_ms"] += cuda_ms(lambda: screen_count_torch(packed, mask, L, k, flat, t, *scratch), iters=3, warmup=1)
        screen["two_pass_ms"] += cuda_ms(lambda: two_pass(packed, mask, L, k, flat, t, *scratch), iters=5, warmup=1)
    screen["bound_ms"], screen["bound_by"] = screen_bound_ms(batches, k, sms, clock_hz)
    # the two-pass path shows every pass the fused kernel replaces, by the
    # names phase 4 looks for
    packed, mask, _rows, L = staged.device[0]
    prof = profile_run(lambda: two_pass(packed, mask, L, k, flat, t, *new_counts(flat.shape[0])),
                       counted=((hash_kernels.kmer_hashes, "kmer_hash_kernel"),))
    seen = sorted({p for name, _ms, _n in prof["device_ms"] for p in PASSES_FUSED if p in name})
    if not set(PASSES_FUSED[:3]) <= set(seen) or not set(PASSES_FUSED[3:]) & set(seen):
        raise AssertionError(f"the two-pass path's device passes are not all named as expected: {seen}")
    screen["two_pass_passes"] = seen
    screen["valid_windows"] = sum(b[1] for b in batches)
    screen["survivors"] = sum(b[2] for b in batches)
    sketch_cases, sketch_err = [], 0.0
    for name, h, v, s, segments in bottom_sketch_edge_sets(seed):
        h, v = torch.from_numpy(h).cuda(), torch.from_numpy(v).cuda()
        want = sketch_kernels.bottom_sketch_torch(h, v, s, segments)
        got = sketch_kernels.bottom_sketch(h, v, s, segments)
        sketch_err = max(sketch_err, check_equal(f"bottom_sketch, {name}", got, want))
        sketch_cases.append([name, *h.shape, s, want[1].tolist()[:8]])
    cases["bottom_sketch"] = sketch_cases
    codes_cases, codes_err = [], 0.0
    for name, codes, k, s in sketch_codes_edge_sets(seed):
        codes = torch.from_numpy(codes).cuda()
        want = sketch_kernels.sketch_codes_torch(codes, k, s)
        got = sketch_kernels.sketch_codes(codes, k, s)
        codes_err = max(codes_err, check_equal(f"sketch_codes, {name}", got, want))
        codes_cases.append([name, *codes.shape, k, s, want[1].tolist()[:8]])
    cases["sketch_codes"] = codes_cases
    emit("kernel", t0, cases=cases, identical=True, sms=sms, clock_mhz=clock_hz / 1e6,
         kmer_hash={"shape": [MAIN_B, MAIN_L], "k": MAIN_K, "ms": hash_ms, "plain_ms": hash_plain_ms,
                    "bound_ms": hash_bound, "bound_by": hash_by,
                    "window_ops": window_ops(MAIN_K, screen=False)},
         screen_count={"staged_screen": screen, "k": k, "F": int(flat.shape[0]),
                       "window_ops": window_ops(k, screen=True),
                       "batches": [["rows", "W", "L", "valid", "survivors", "hits"], *shapes]})
    return {
        "kmer_hash": {"max_abs_err": max_err["kmer_hash"], "ms": hash_ms, "plain_ms": hash_plain_ms,
                      "bound_ms": hash_bound, "bound_by": hash_by},
        "screen_count": {"max_abs_err": max_err["screen_count"], "ms": screen["ms"],
                         "plain_ms": screen["plain_ms"], "bound_ms": screen["bound_ms"],
                         "bound_by": screen["bound_by"]},
        "bottom_sketch": {"max_abs_err": sketch_err},
        "sketch_codes": {"max_abs_err": codes_err},
    }


def limit_stage(workdir: str, cfg: RunConfig) -> int:
    """The candidate limit as ClassificationRun runs it: cap the union at
    cand_max, scored by every *_sorted.tab, and replace the list in place."""
    selected = os.path.join(workdir, "selected_genomes.txt")
    score_files = sorted(
        os.path.join(workdir, f) for f in os.listdir(workdir) if f.endswith("_sorted.tab")
    )
    limit_candidates_files(
        selected, selected + ".limited", score_files,
        max_candidates=cfg.cand_max, dedupe=cfg.species_dedup,
        assembly_dir=cfg.assembly_summary_dir,
    )
    os.replace(selected + ".limited", selected)
    with open(selected) as f:
        return sum(1 for _ in f)


def load_world_dbs() -> list:
    return [load_sketch_db(os.path.join(WORLD, f"{label}.npz")) for label in DB_LABELS]


def stage_contigs(cfg: RunConfig) -> StagedContigs:
    """The upload stage as ClassificationRun runs it (run.py:208-240)."""
    names, seqs = read_fasta(CONTIGS)
    return StagedContigs(names, seqs, cfg.align_batch_pad, cfg.align_k + cfg.align_w, device="cuda")


def screen(workdir: str, cfg: RunConfig, dbs, labels, staged):
    """The screen stage as ClassificationRun runs it (run.py:242-269)."""
    return run_screen_stage(
        dbs, [CONTIGS], workdir, initial_threshold=cfg.mash_thresh, db_labels=labels,
        chunk_bp=cfg.screen_chunk_bp, staged=staged, device="cuda",
    )


def counting_with(count_fn):
    """Context in which every ScreenEngine built counts with `count_fn`:
    the engine's test seam, its default swapped, so a check drives the
    same stage with the plain count."""
    return mock.patch.dict(ScreenEngine.__init__.__kwdefaults__, count_fn=count_fn)


def run_slice(workdir: str, cfg: RunConfig, staged: bool) -> dict:
    """contigs -> (staged upload) -> screen -> limit, in ClassificationRun's order."""
    times = {}
    t = time.perf_counter()
    batches = stage_contigs(cfg) if staged else None
    torch.cuda.synchronize()
    times["upload_s"] = time.perf_counter() - t
    t = time.perf_counter()
    screen(workdir, cfg, load_world_dbs(), DB_LABELS, batches)
    torch.cuda.synchronize()
    times["screen_s"] = time.perf_counter() - t
    t = time.perf_counter()
    times["selected"] = limit_stage(workdir, cfg)
    times["limit_s"] = time.perf_counter() - t
    return times


def screen_files(workdir: str) -> list:
    return sorted(f for f in os.listdir(workdir) if f.endswith(".tab") or f.endswith(".txt"))


def same_files(a: str, b: str, names) -> None:
    for name in names:
        if not filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False):
            raise AssertionError(f"{name} differs between {a} and {b}")


def phase_slice(tmp: str, cfg: RunConfig) -> tuple:
    t0 = time.perf_counter()
    runs = {}
    launches = {}
    for tag, staged, count_fn in (
        ("kernel_staged", True, hash_kernels.screen_count),
        ("plain_staged", True, screen_count_torch),
        ("kernel_chunked", False, hash_kernels.screen_count),
    ):
        hash_kernels.screen_count.launches = 0
        hash_kernels.kmer_hashes.launches = 0
        with counting_with(count_fn):
            runs[tag] = run_slice(os.path.join(tmp, tag), cfg, staged)
        launches[tag] = {"screen_count": hash_kernels.screen_count.launches,
                         "kmer_hash": hash_kernels.kmer_hashes.launches}
    ref = os.path.join(tmp, "kernel_staged")
    files = screen_files(ref)
    if len(files) != 4 * len(DB_LABELS) + 1:
        raise AssertionError(f"unexpected screen outputs: {files}")
    for tag in ("plain_staged", "kernel_chunked"):
        same_files(ref, os.path.join(tmp, tag), files)
    if launches["kernel_staged"]["screen_count"] <= 0 or launches["kernel_chunked"]["screen_count"] <= 0:
        raise AssertionError(f"screen_count kernel not launched on the slice: {launches}")
    if launches["plain_staged"]["screen_count"] != 0:
        raise AssertionError("the plain run launched the kernel")
    if any(n["kmer_hash"] for n in launches.values()):
        raise AssertionError(f"the slice went through the standalone hash kernel: {launches}")
    selected = runs["kernel_staged"]["selected"]
    if selected <= 0:
        raise AssertionError("no genome selected")
    staged, dbs = stage_contigs(cfg), load_world_dbs()
    prof = profile_run(lambda: screen(os.path.join(tmp, "profiled"), cfg, dbs, DB_LABELS, staged),
                       counted=((hash_kernels.screen_count, "screen_count_kernel"),))
    # the screen's update is one screen_count launch a batch: none of the
    # unpack's stack, the standalone hash, searchsorted or index_add_ passes
    names = {name: count for name, _ms, count in prof["device_ms"]}
    launched = sum(c for name, c in names.items() if "screen_count_kernel" in name)
    gone = [name for name in names for pass_ in PASSES_FUSED if pass_ in name]
    if launched != len(staged.device) or prof["launches"]["screen_count_kernel"] != launched \
            or gone:
        raise AssertionError(f"staged screen ran {launched} screen_count launches in the trace, "
                             f"{prof['launches']['screen_count_kernel']} counted, for "
                             f"{len(staged.device)} batches, and {gone}")
    emit("slice", t0, files_identical=files, launches=launches, selected_genomes=selected,
         runs=runs, staged_screen_profile=prof)
    return ref, launches["kernel_staged"]


def synthetic_db(seed: int, n_refs: int = 100_000, s: int = 1000) -> SketchDB:
    """RefSeq-sized bottom sketches: per reference s sorted hashes drawn
    uniformly below 2^64 * 1000 / 5e6 (a 5 Mbp genome's bottom-1000
    threshold), made on the card from `seed`."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    top = int(2**64 * 1000 / 5e6)
    h = torch.randint(0, top, (n_refs, s), generator=gen, device="cuda", dtype=torch.int64)
    hashes = torch.sort(h, dim=1).values.cpu().numpy().view(np.uint64)
    return SketchDB(
        k=21, sketch_size=s, hashes=hashes, n_hashes=np.full(n_refs, s, np.int32),
        names=[f"SYN_{i:06d}" for i in range(n_refs)],
        lengths=np.full(n_refs, 5_000_000, np.int64), comments=[""] * n_refs,
    )


def phase_scale(tmp: str, cfg: RunConfig, seed: int, small_ref: str, kernel_ms: float) -> None:
    """`kernel_ms`: screen_count's device time for one staged screen, its
    launches timed alone (phase 3)."""
    t0 = time.perf_counter()
    synth = synthetic_db(seed)
    dbs = load_world_dbs() + [synth]
    labels = DB_LABELS + ["synthetic"]
    F = int(flat_index_device(SketchDB.concat(dbs).hashes, torch.device("cuda"))[0].numel())
    staged = stage_contigs(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3):
        out = os.path.join(tmp, f"scale{i}")
        t = time.perf_counter()
        screen(out, cfg, dbs, labels, staged)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        same_files(small_ref, out, [f"{label}_sorted.tab" for label in DB_LABELS])
    peak = torch.cuda.max_memory_allocated()
    prof = profile_run(lambda: screen(os.path.join(tmp, "scale_profiled"), cfg, dbs, labels, staged))
    median_s = statistics.median(times)
    emit("scale", t0, refs=sum(db.n_refs for db in dbs), flat_hashes=F,
         screen_s=times, screen_median_s=median_s, kernel_ms_per_screen=kernel_ms,
         kernel_share=kernel_ms / 1e3 / median_s, staged_batches=len(staged.device),
         max_memory_allocated=peak, sorted_tab_identical_to_slice=True, screen_profile=prof)


# ----------------------------------------------------------------------
# the align slice


def minimizer_ops(k: int) -> tuple:
    """(ALU, multiply-add) 32-bit instructions the minimizer function needs
    per window with a valid k-mer, counted from the function (64-bit
    add, logic op or shift 2, compare or select 2, multiply by a constant
    3 multiply-adds):

    - the forward and reverse-complement 2k-bit words, rolled by one base:
      shift, insert and mask each (6 and 5), the validity count of the
      window (2), their compare (2), the canonical select (2) and the
      strand bit (1): 18;
    - hash64 (k <= 32 in one 64-bit word): ``~key + (key << 21)``,
      ``key * 265``, ``key * 21`` and ``key + (key << 31)`` are multiplies
      by constants (4 x 3 multiply-adds) each masked to 2k bits (4 x 2),
      and three shift-XORs (3 x 4): ALU 20, multiply-add 12;
    - the sentinel for an invalid k-mer (2);
    - the sliding minimum, amortised: the new k-mer against the current
      minimum (2), the select of its position (1), the test whether the
      minimum left the window (1): 4;
    - keep: a new position (1), not the sentinel (2), and (1): 4.
    """
    del k  # the same for every k <= 32: one 64-bit word
    return 18 + 20 + 2 + 4 + 4, 12


def minimizer_bound_ms(batches, k: int, sms: int, clock_hz: float) -> tuple:
    """(least time in ms, what bounds it) for ``minimizers`` over batches
    given as (input bytes, windows holding a valid k-mer, kept minimizers):
    operations only for windows with a valid k-mer (a window of padding
    needs none); packed and mask read once, each kept minimizer's (hash,
    pos, strand, row) written once (8 + 4 + 1 + 4 bytes). The [cap] slots
    past the last kept one are not counted: the JAX compaction leaves them
    as they are and every consumer reads only the first n_kept."""
    alu, mad = minimizer_ops(k)
    nbytes = sum(b + 17 * kept for b, _, kept in batches)
    n = sum(v for _, v, _ in batches)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops_ms(n * alu, n * mad, sms, clock_hz)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def search_stats(hash_: torch.Tensor, tables: align_kernels.AnchorTables) -> tuple:
    """(dependent loads, bucket-table entries, unique-hash entries) of the
    anchors kernel's search for these hashes (``bucket_lower_bound``, step
    by step as the kernel takes it): a bucket's two bounds, a load a step,
    and the entry it lands on. The loads are summed over the hashes; each
    table entry is counted once, however often the searches read it."""
    t, lo, probes = align_kernels.bucket_lower_bound(hash_, tables.uniq, tables.bucket, tables.shift)
    landed = lo[lo < tables.bucket[t + 1]]
    loads = sum(int(p.numel()) for p in probes) + int(landed.numel())
    buckets = torch.unique(torch.cat([t, t + 1])).numel()
    return loads, buckets, torch.unique(torch.cat([*probes, landed])).numel()


def anchor_bound_ms(batches, sms: int, clock_hz: float) -> tuple:
    """(least time in ms, what bounds it) for ``anchors`` over batches given
    as (kept minimizers n, search loads, bucket entries, unique-hash
    entries, anchors a, acap), the search counts from :func:`search_stats`:

    - bytes: per kept minimizer its 17 bytes read and one 8-byte run-offset
      row; each bucket-table entry (4 bytes) and unique hash (8 bytes) the
      searches touch, read once; per anchor kept (min(a, acap)) its 8-byte
      payload row read and its sorted key, qpos and rpos (16 bytes)
      written once; per empty slot past them the sentinel key and zero qpos
      and rpos (16 bytes), which the reference writes too. The sort's
      passes over the anchors are the kernel's design, not the function's;
    - operations: 6 ALU instructions a search load, about 12 per anchor for
      its keys."""
    nbytes = n_alu = 0
    for n, loads, buckets, entries, a, acap in batches:
        filled = min(a, acap)
        nbytes += n * (17 + 8) + 4 * buckets + 8 * entries + 24 * filled + 16 * (acap - filled)
        n_alu += 6 * loads + 12 * filled
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops_ms(n_alu, 0, sms, clock_hz)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def chain_bound_ms(batches, sms: int, clock_hz: float) -> tuple:
    """(least time in ms, what bounds it) for ``chains`` over batches given
    as (anchors A, good chains C): each sorted anchor's key, qpos and rpos
    (16 bytes) read once, and the C rows of 9 int32 written once; per anchor
    about 13 ALU instructions (the break test on k1, rel and band 6, four
    min/max 4, the score step 3). The [acap] slots past the last anchor and
    the [ccap] rows past the last chain are not counted: the function
    needs neither."""
    nbytes = sum(16 * A + 36 * C for A, C in batches)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops_ms(13 * sum(A for A, _ in batches), 0, sms, clock_hz)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def zero_launches() -> None:
    for fn in (hash_kernels.screen_count, hash_kernels.kmer_hashes, *align_kernels.KERNELS,
               lca.weighted_lca, sketch_kernels.bottom_sketch, sketch_kernels.sketch_codes):
        fn.launches = 0


def all_launches() -> dict:
    return {"screen_count": hash_kernels.screen_count.launches,
            "kmer_hash": hash_kernels.kmer_hashes.launches, **align_launches(),
            "lca": lca.weighted_lca.launches,
            "bottom_sketch": sketch_kernels.bottom_sketch.launches,
            "sketch_codes": sketch_kernels.sketch_codes.launches}


def align_launches() -> dict:
    return {fn.__name__: fn.launches for fn in align_kernels.KERNELS}


def write_combined(selected: str, out_path: str) -> int:
    """The reference FASTA of the selected genomes, in selected_genomes.txt
    order, as the reference build concatenates them (run.py's reference
    stage): each listed file's lines, a newline added where one is missing.
    Returns the number of genomes."""
    with open(selected) as f:
        names = [ln.strip() for ln in f if ln.strip()]
    with open(out_path, "wb") as out:
        for name in names:
            acc = "_".join(name.split("_")[:2])
            with gzip.open(os.path.join(GENOMES, acc, name), "rb") as g:
                data = g.read()
            out.write(data)
            if data and not data.endswith(b"\n"):
                out.write(b"\n")
    return len(names)


def numpy_index(genomes) -> MinimizerIndex:
    """The index of `genomes` built on the CPU by the numpy twin
    (extract_minimizers_numpy), not the native host helpers: the plain
    version a card's index build is held to."""
    with mock.patch.object(native_io, "available", lambda: False):
        return MinimizerIndex.build(genomes, device="cpu")


def same_index(a: MinimizerIndex, b: MinimizerIndex) -> bool:
    return all(
        getattr(a, f).dtype == getattr(b, f).dtype and np.array_equal(getattr(a, f), getattr(b, f))
        for f in ("hashes", "seq_id", "pos", "strand", "lengths")
    )


def plain_ops():
    """Context in which every MinimizerAligner built runs the plain versions:
    the aligner's test seam, its default swapped."""
    return mock.patch.dict(MinimizerAligner.__init__.__kwdefaults__, ops=align_kernels.PLAIN)


def phase_align(tmp: str, cfg: RunConfig) -> tuple:
    t0 = time.perf_counter()
    names, seqs = read_fasta(CONTIGS)
    staged = stage_contigs(cfg)
    work = os.path.join(tmp, "align_kernel")
    screen(work, cfg, load_world_dbs(), DB_LABELS, staged)
    n_selected = limit_stage(work, cfg)
    ref_dir = os.path.join(tmp, "reference")
    os.makedirs(ref_dir)
    combined = os.path.join(ref_dir, "combined_genomes.fasta")
    n_genomes = write_combined(os.path.join(work, "selected_genomes.txt"), combined)
    torch.cuda.synchronize()
    # the main path: index build on the card, map, PAF
    zero_launches()
    t = time.perf_counter()
    paf = run_align_stage(combined, names, seqs, work, cfg, staged=staged, device="cuda")
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t
    launches = align_launches()
    if min(launches.values()) <= 0:
        raise AssertionError(f"an align kernel was not launched on the main path: {launches}")
    # the same stage with the plain versions, on the cached index
    plain_work = os.path.join(tmp, "align_plain")
    with plain_ops():
        plain_paf = run_align_stage(combined, names, seqs, plain_work, cfg, staged=staged, device="cuda")
    torch.cuda.synchronize()
    if align_launches() != launches:
        raise AssertionError("the plain align stage launched an align kernel")
    if not filecmp.cmp(paf, plain_paf, shallow=False):
        raise AssertionError("resultados.paf differs between the kernel path and the plain path")
    with open(paf) as f:
        n_records = sum(1 for _ in f)
    if n_records == 0:
        raise AssertionError("the align stage wrote no record")
    # the index: its build on the card timed, and equal to the numpy twin's
    # on the first >= 5 Mbp of the reference
    t = time.perf_counter()
    index = MinimizerIndex.build_from_fasta(combined, device="cuda")
    index_s = time.perf_counter() - t
    part, bp = [], 0
    for name, seq in iter_fasta(combined):
        part.append((name, seq))
        bp += len(seq)
        if bp >= 5_000_000:
            break
    t = time.perf_counter()
    if not same_index(MinimizerIndex.build(part, device="cuda"), numpy_index(part)):
        raise AssertionError("the card's index differs from the numpy twin's")
    check_s = time.perf_counter() - t
    # map_batch: median of 3, peak memory, one profiled run
    aligner = MinimizerAligner(index, AlignerConfig(batch_pad=cfg.align_batch_pad), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, lines = [], None
    for _ in range(3):
        t = time.perf_counter()
        records = aligner.map_batch(names, seqs, staged=staged)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        got = [r.to_line() + "\n" for r in records]
        if lines is not None and got != lines:
            raise AssertionError("map_batch differs between runs")
        lines = got
    with open(paf) as f:
        if f.readlines() != lines:
            raise AssertionError("map_batch differs from resultados.paf")
    peak = torch.cuda.max_memory_allocated()
    prof = profile_run(lambda: aligner.map_batch(names, seqs, staged=staged),
                       counted=((align_kernels.minimizers, "minimizer_tile_kernel"),
                                (align_kernels.anchors, "anchor_search_kernel")), lost=ANY_LOST)
    minimizer_split = minimizer_activities(prof, aligner, index, staged)
    anchor_split = anchor_activities(prof, aligner, staged)
    emit("align", t0, selected_genomes=n_selected, reference_genomes=n_genomes,
         reference_bp=int(index.lengths.sum()), reference_sequences=len(index.names),
         index_minimizers=index.n_minimizers, index_build_s=index_s,
         index_equal_to_numpy_bp=bp, index_check_s=check_s, stage_s=stage_s,
         map_batch_s=times, map_batch_median_s=statistics.median(times), records=n_records,
         paf_identical_to_plain=True, launches=launches, staged_batches=len(staged.device),
         boosts={"cap": aligner._cap_boost, "acap": aligner._acap_boost, "ccap": aligner._ccap_boost},
         max_memory_allocated=peak, map_batch_profile=prof, minimizers_device=minimizer_split,
         anchors_device=anchor_split)
    return index, staged, launches, combined


# device activities a minimizers call may make: its two kernels and the
# memset of its status words
MINIMIZER_ACTIVITIES = 3
PROFILED_CALLS = 8


def minimizer_activities(prof: dict, aligner: MinimizerAligner, index: MinimizerIndex,
                         staged) -> dict:
    """The minimizers kernels in a profiled map_batch (name, ms, count), and
    the device activities (kernels and memsets) of PROFILED_CALLS calls
    alone on the first staged batch, per call, from a trace that lacks at
    most one call's tile launch (the profiler drops one call's activities
    from most such traces, so each kind's count is rounded per call).
    Raises unless the tile kernel shows once a call and a call makes at
    most MINIMIZER_ACTIVITIES, or if map_batch ran more than two
    minimizers kernels a batch."""
    kernels = [row for row in prof["device_ms"] if "minimizer" in row[0]]
    packed, mask, B, L = staged.device[0]
    cap = aligner._minimizer_cap(B, L)[1]
    calls = profile_run(lambda: [align_kernels.minimizers(packed, mask, L, index.k, index.w, cap)
                                 for _ in range(PROFILED_CALLS)],
                        counted=((align_kernels.minimizers, "minimizer_tile_kernel"),), lost=1)
    per_call = {name: round(count / PROFILED_CALLS) for name, _ms, count in calls["device_ms"]}
    activities = sum(per_call.values())
    tile = sum(n for name, n in per_call.items() if "minimizer_tile_kernel" in name)
    if tile != 1 or activities > MINIMIZER_ACTIVITIES or \
            sum(c for _n, _ms, c in kernels) > 2 * len(staged.device):
        raise AssertionError(f"minimizers made {activities} device activities a call "
                             f"({calls['device_ms']}) and {kernels} in map_batch")
    return {"map_batch_kernels": kernels, "calls": calls["device_ms"],
            "activities_per_call": per_call}


# torch's sort and gather kernels: none may run in map_batch, whose anchors
# come sorted from the anchors kernel
LIBRARY_SORT_GATHER = ("sort", "gather", "index_elementwise", "indexselect", "index_select")


def anchor_activities(prof: dict, aligner: MinimizerAligner, staged) -> dict:
    """The anchors kernels in a profiled map_batch (name, ms, count), and
    the device activities of PROFILED_CALLS ``anchors`` calls alone on the
    first staged batch, per call, from a trace that lacks at most one
    call's search launch. Raises if map_batch ran a torch sort or
    gather kernel, or if a call makes more device activities than
    ``SortLayout.launches`` states or no scatter pass shows."""
    library = [row for row in prof["device_ms"]
               if any(word in row[0].lower() for word in LIBRARY_SORT_GATHER)]
    packed, mask, B, L = staged.device[0]
    NW, cap = aligner._minimizer_cap(B, L)
    acap = aligner._device_caps(B, NW, cap)[0]
    cfg, tables = aligner.cfg, aligner._tables
    mz = align_kernels.minimizers(packed, mask, L, aligner.index.k, aligner.index.w, cap)
    args = (*mz, tables, cfg.max_occ, cfg.band_bits, acap, B, L)
    stated = align_kernels.sort_layout(tables, B, L, cfg.band_bits).launches
    calls = profile_run(lambda: [align_kernels.anchors(*args) for _ in range(PROFILED_CALLS)],
                        counted=((align_kernels.anchors, "anchor_search_kernel"),), lost=1)
    per_call = {name: round(count / PROFILED_CALLS) for name, _ms, count in calls["device_ms"]}
    activities = sum(per_call.values())
    if library or activities > stated or \
            not any("anchor_digit_scatter_kernel" in name for name in per_call):
        raise AssertionError(f"map_batch ran torch sort or gather kernels {library}, or an anchors "
                             f"call made {activities} device activities (stated {stated}): "
                             f"{calls['device_ms']}")
    return {"map_batch_kernels": [row for row in prof["device_ms"] if "anchor" in row[0]],
            "calls": calls["device_ms"], "activities_per_call": per_call,
            "stated_launches": stated}


def check_equal(name: str, got, want) -> float:
    """Raise unless every output equals the plain version's bit for bit
    (float64 outputs by their bit patterns); returns the largest absolute
    difference (0.0)."""
    torch.cuda.synchronize()

    def bits(x):
        return x.view(torch.int64) if x.dtype == torch.float64 else x

    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"{name}: output {i} differs from the plain version")
    return max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
               for a, b in zip(got, want))


def edge_world(rng: np.random.Generator):
    """A repetitive index (one unit in 16 and in 17 copies, so that some
    hashes occur max_occ times and some more, and a 40 kbp genome a contig
    covers whole) and query rows for it."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    unit = acgt[rng.integers(0, 4, 3000)].tobytes()
    other = acgt[rng.integers(0, 4, 3000)].tobytes()
    long_g = acgt[rng.integers(0, 4, 40000)].tobytes()
    genomes = [(f"u{i}", unit) for i in range(16)] + [(f"o{i}", other) for i in range(17)]
    genomes.append(("long", long_g))
    index = numpy_index(genomes)
    rows = [unit, other, long_g, unit[:500] + other[:500], unit[:30]]
    return index, rows


CHAIN_TILE = 2048  # anchors a block of csrc/chains.cu owns
CHAIN_ARGS = (19, 3, 40)  # k, min_cnt, min_mlen: AlignerConfig's defaults at k = 19
CHAIN_CCAP = 4096
CHAIN_A = 6 * CHAIN_TILE + 5


class _AnchorSet:
    """Sorted anchors built chain by chain as (k1, k2, qpos, rpos), in the
    sort order of csrc/anchors.cu's keys: each chain breaks from the one
    before it by a new k1 (qid << 26 | seq), a new rel, or a band jump of at
    least 2; within a chain the band steps by 0 or 1."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng
        self.k1, self.k2, self.p, self.r = [], [], [], []
        self.group, self.rel, self.band = -1, 0, 0

    def __len__(self) -> int:
        return len(self.k1)

    def chain(self, n: int, brk: str = "group", band_steps=None, q_steps=None,
              qpos=None) -> None:
        """Appends a chain of n anchors, broken from the last by `brk`."""
        rng, k = self.rng, CHAIN_ARGS[0]
        if brk == "group" or self.group < 0 or (brk == "rel" and self.rel == 1):
            self.group, self.rel, self.band = self.group + 1, 0, int(rng.integers(0, 100))
        elif brk == "rel":
            self.rel = 1
        else:  # a band jump
            self.band += 2 + int(rng.integers(0, 3))
        if band_steps is None:
            band_steps = rng.integers(0, 2, n - 1)
        bands = self.band + np.concatenate([[0], np.cumsum(band_steps)]).astype(np.int64)
        self.band = int(bands[-1])
        if qpos is None:
            if q_steps is None:
                q_steps = rng.choice([-50, -1, 0, 1, 2, k - 1, k, k + 1, 3 * k], n - 1,
                                     p=[.02, .02, .04, .2, .2, .1, .2, .12, .1])
            qpos = 1_000_000 + np.concatenate([[0], np.cumsum(q_steps)])
        g = self.group
        self.k1 += [(g >> 10) << 26 | (g & 1023)] * n
        self.k2 += list((self.rel << 24) | bands)
        self.p += list(np.asarray(qpos, np.int64))
        self.r += list(rng.integers(0, 1 << 30, n))

    def fill_to(self, end: int, longest: int = 40) -> None:
        """Random chains (by a random break) up to anchor `end`, exclusive."""
        while len(self) < end:
            n = min(int(self.rng.integers(1, longest + 1)), end - len(self))
            self.chain(n, brk=str(self.rng.choice(["group", "rel", "band"])))

    def arrays(self, A: int) -> tuple:
        """(key int64, qpos int32, rpos int32), each [A]: the anchors, then
        padding (key 2^63 - 1, zeros) up to A."""
        n = len(self)
        raw = (np.array(self.k1, np.uint64) << np.uint64(32)) | np.array(self.k2, np.uint64)
        key = np.full(A, (1 << 63) - 1, np.int64)
        key[:n] = (raw ^ np.uint64(1 << 63)).view(np.int64)
        p, r = np.zeros(A, np.int32), np.zeros(A, np.int32)
        p[:n], r[:n] = self.p, self.r
        return key, p, r


def chain_edge_sets(seed: int = 0, longest: bool = False) -> list:
    """Sorted synthetic anchor sets for ``chains`` at csrc/chains.cu's tile
    edges, as (name, key, qpos, rpos, (k, min_cnt, min_mlen, ccap)). Anchor
    counts 1, T - 1, T, T + 1, 3T + 5 and 6T + 5 (T = 2048 anchors a tile);
    a chain over 5+ tiles; chains that start at tile starts and end at tile
    ends, and a tile that is one whole chain; band steps of 0, 1 and 2, a
    new rel and a new k1 across tile boundaries; qpos stepping backwards and
    by more than k; cnt = min_cnt - 1 and min_cnt, mlen = min_mlen - 1 and
    min_mlen, across boundaries and within a tile; padding from mid-tile
    (also 3 anchors of it at the end with min_mlen <= k, where only its key
    keeps the padding chain out), from a tile start, none and only padding;
    a ccap that cuts the rows. With `longest`, also a chain over 260 tiles
    (more than one round of the kernel's look-back, 256 tiles a round)."""
    rng = np.random.default_rng(seed)
    T, (k, min_cnt, min_mlen) = CHAIN_TILE, CHAIN_ARGS
    sets = []

    def add(name, s, A=CHAIN_A, ccap=CHAIN_CCAP, mlen=min_mlen):
        sets.append((name, *s.arrays(A), (k, min_cnt, mlen, ccap)))

    for A in (1, T - 1, T, T + 1, 3 * T + 5):
        s = _AnchorSet(rng)
        s.fill_to(A)
        add(f"A={A}", s, A)
    s = _AnchorSet(rng)
    s.fill_to(1000)
    s.chain(5 * T + 700)  # tiles 0 .. 5
    s.fill_to(CHAIN_A)
    add("chain_over_5_tiles", s)
    s = _AnchorSet(rng)
    s.fill_to(T - 1)
    s.chain(1)  # one anchor at a tile end
    s.chain(T)  # a tile that is one whole chain
    s.chain(1)  # one anchor at a tile start
    s.chain(T - 1)  # ends at a tile end
    s.chain(3 * T // 2, brk="band")  # starts at a tile start, over a boundary
    s.fill_to(5 * T)
    s.chain(T + 1, brk="rel")
    s.fill_to(CHAIN_A)
    add("tile_starts_and_ends", s)
    s = _AnchorSet(rng)
    for b, step in enumerate((0, 1, 2, "rel", "group"), start=1):
        s.fill_to(b * T - 7)
        if isinstance(step, int):  # the band steps by `step` from the tile's last anchor
            s.chain(14, band_steps=[step * (j == 6) for j in range(13)])
        else:
            s.chain(7)
            s.chain(7, brk=step)
    s.fill_to(CHAIN_A)
    add("band_steps_at_boundaries", s)
    s = _AnchorSet(rng)
    for b in range(1, 6):
        s.fill_to(b * T - 3)
        s.chain(6, q_steps=[-40, k + 7, -1, 3 * k, 0])
    s.fill_to(CHAIN_A)
    add("qpos_back_and_past_k", s)
    s = _AnchorSet(rng)
    q0 = 1_000_000
    span_bad, span_good = min_mlen - 1 - k, min_mlen - k  # mlen = span + k
    for b, (n, qpos) in enumerate((
            (min_cnt - 1, None), (min_cnt, None),
            (6, q0 + np.array([0, 3, span_bad, 7, 1, 2])),
            (6, q0 + np.array([0, 3, span_good, 7, 1, 2])))):
        for at in (b * T + 500, (b + 1) * T - n // 2):  # within a tile, then over a boundary
            s.fill_to(at)
            s.chain(n, q_steps=[3 * k] * (n - 1) if qpos is None else None, qpos=qpos)
    s.fill_to(CHAIN_A)
    add("cnt_and_mlen_thresholds", s)
    for name, valid, mlen in (("padding_from_mid_tile", 2 * T + 904, min_mlen),
                              ("padding_ends_in_last_tile_min_mlen_below_k", CHAIN_A - 3, k // 2),
                              ("padding_from_tile_start", 2 * T, min_mlen),
                              ("only_padding", 0, k // 2)):
        s = _AnchorSet(rng)
        s.fill_to(valid)
        add(name, s, mlen=mlen)
    s = _AnchorSet(rng)
    s.fill_to(CHAIN_A, longest=8)
    add("ccap_cuts_rows", s, ccap=5)
    if longest:
        s = _AnchorSet(rng)
        s.fill_to(T + 100)
        s.chain(260 * T)
        s.fill_to(262 * T + 5)
        add("chain_over_260_tiles", s, A=263 * T)
    return sets


MAX_OCC = 16  # AlignerConfig's default


def anchor_edge_sets(seed: int = 0) -> list:
    """Worlds for ``anchors`` at its search's and sort's edges, as (name,
    genomes [(name, bytes)], codes [B, L] uint8, band_bits, acap): an index
    of the genomes at k = w = 19 and query rows against it, mapped at
    max_occ 16 with a cap that holds every kept minimizer.
    ``all_ties``: a 60 bp unit 16 times in tandem, whose minimizers occur
    15-16 times each in one sequence, in query rows that repeat the tandem
    (a minimizer's anchors and its neighbours' share a band: runs of equal
    keys, over several sort tiles). ``overflow``: the same at an acap below
    n_anchors. ``empty_rows``: rows without anchors first, in the middle
    and last, the others holding both strands of one sequence (rel 0 and 1
    under one qid and seq, rel 1 first and on lower bands). ``no_anchors``: random rows, n_anchors = 0.
    ``many_short_refs``: 3000 references of 200 bp in 64 rows, some reverse
    complemented, at band_bits 1: a compact key of 43 bits (the gut world's
    is about 28), held in 64 bits. ``band_extremes``: the start of the
    longest reference at the end of a row (the most negative diagonal), its
    end reverse complemented at the end of a row (rel = 1 at the largest
    rpos + qpos) and at the start of a row, at band_bits 1 and 24."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def bases(n: int) -> np.ndarray:
        return rng.integers(0, 4, n).astype(np.uint8)

    def text(codes: np.ndarray) -> bytes:
        return acgt[codes].tobytes()

    def revcomp(codes: np.ndarray) -> np.ndarray:
        return (3 - codes)[::-1]

    sets = []
    tandem = np.tile(bases(60), 16)
    genomes = [("tandem", text(np.concatenate([bases(500), tandem, bases(500)]))),
               ("other", text(bases(5000)))]
    codes = np.full((8, 8192), 4, np.uint8)
    for r in range(8):
        row = np.concatenate([np.concatenate([tandem, bases(100)]) for _ in range(6)])
        codes[r, : len(row)] = row
    sets.append(("all_ties", genomes, codes, 11, 1 << 17))
    sets.append(("overflow", genomes, codes, 11, 5000))
    genome = bases(20000)
    codes = bases(7 * 4096).reshape(7, 4096)
    for r in (1, 2, 4, 5):  # both strands of one sequence in a row, rel 1 at lower bands
        at, at2 = int(rng.integers(12000, 20000 - 2048)), int(rng.integers(0, 4000))
        codes[r] = np.concatenate([revcomp(genome[at2 : at2 + 2048]), genome[at : at + 2048]])
    codes[3, 2000:] = 4
    sets.append(("empty_rows", [("g", text(genome))], codes, 11, 1 << 15))
    sets.append(("no_anchors", [("g", text(genome))], bases(4 * 2048).reshape(4, 2048), 11, 4096))
    refs = [bases(200) for _ in range(3000)]
    codes = np.full((64, 2048), 4, np.uint8)
    for r in range(64):
        pieces = [refs[i] if rng.random() < 0.5 else revcomp(refs[i])
                  for i in rng.integers(0, len(refs), 10)]
        row = np.concatenate(pieces)[:2048]
        codes[r, : len(row)] = row
    sets.append(("many_short_refs", [(f"s{i}", text(x)) for i, x in enumerate(refs)], codes, 1,
                 1 << 16))
    long_g, short_g = bases(30000), bases(3000)
    L = 4096
    codes = np.full((4, L), 4, np.uint8)
    codes[0, L - 200 :] = long_g[:200]
    codes[1, L - 1000 :] = revcomp(long_g[-1000:])
    codes[2, :1000] = revcomp(long_g[-1000:])
    codes[3] = bases(L)
    for band_bits in (1, 24):
        sets.append((f"band_extremes_{band_bits}", [("long", text(long_g)), ("short", text(short_g))],
                     codes, band_bits, 1 << 14))
    return sets


def anchor_inputs(genomes, codes: np.ndarray, device="cpu") -> tuple:
    """An edge set's index (built on the CPU by numpy), its aligner's anchor tables
    and the minimizers of its rows (``minimizers_torch``, a cap of every
    window), on `device`: (index, tables, minimizer outputs, B, L)."""
    index = numpy_index(genomes)
    tables = MinimizerAligner(index, device=device)._tables
    packed, mask, L = pack_code_batch(codes)
    B = codes.shape[0]
    cap = B * (L - index.k - index.w + 2)
    mz = align_kernels.minimizers_torch(torch.from_numpy(packed).to(device),
                                        torch.from_numpy(mask).to(device), L, index.k, index.w, cap)
    return index, tables, mz, B, L


MIN_TILE = 2048  # windows a block of csrc/minimizers.cu owns
MIN_ROWS, MIN_L = 4, 7 * MIN_TILE  # the CPU-sized edge sets: 7 tiles a row at k + w <= 38


def lowest_kmer(rng: np.random.Generator, k: int, n: int = 200_000) -> np.ndarray:
    """The codes of the k-mer with the least hash64 among the k-mers of n
    random bases: placed anywhere, it is the one minimum of every window
    that holds it (another k-mer's hash falls below it with odds of about
    w / n)."""
    codes = rng.integers(0, 4, n).astype(np.uint8)
    h, p, _ = extract_minimizers_numpy(codes, k, 1)
    i = int(p[np.argmin(h)])
    return codes[i : i + k].copy()


def minimizer_edge_sets(seed: int = 0, big: bool = False) -> list:
    """Code batches for ``minimizers`` at csrc/minimizers.cu's tile edges, as
    (name, codes [B, L] uint8, row_len [B] int32, k, w); T = 2048 windows a
    tile. ``kept_at_tile_edges`` (k = w = 19): the lowest k-mer (an
    unbeatable minimum) at k-mer T + w - 2 of row 0, so that window T - 1,
    a tile's last slot, is kept with its minimum in the tile's right halo;
    at k-mer 2T + w - 1, so that window 2T, a tile's first slot, is kept;
    at k-mer 3T - 1, a minimum in tile 3's left halo (window 3T - 1); row 1's
    valid bases end inside tile 0's right halo; row 2 holds tiles 2-4 of N
    between valid tiles; row 3's row_len ends mid-tile (tiles 3-6 past it).
    ``every_window_kept``: an AT repeat (odd k: both k-mers of the period
    share one canonical hash, so every window's leftmost minimum is new),
    the same with row_len mid-tile, a poly-A row and a random row.
    ``wide_window`` (k = 15, w = 256: 145 runs of 16 k-mers a tile): the
    lowest k-mer at the farthest halo k-mer of tile 0, T + w - 2. With
    `big`, also ``more_tiles_than_resident`` (64 rows of 70 tiles, 4480
    tiles, most of them working: more than one look-back step of 32 tiles
    and more tiles than the card holds at once). Every set's row_len is
    given; a caller runs each with and without it."""
    rng = np.random.default_rng(seed)
    T, sets = MIN_TILE, []
    for name, k, w in (("kept_at_tile_edges", 19, 19), ("every_window_kept", 19, 19),
                       ("wide_window", 15, 256)):
        low = lowest_kmer(rng, k)
        codes = rng.integers(0, 4, (MIN_ROWS, MIN_L)).astype(np.uint8)
        row_len = np.full(MIN_ROWS, MIN_L, np.int32)
        if name == "kept_at_tile_edges":
            for at in (T + w - 2, 2 * T + w - 1, 3 * T - 1):
                codes[0, at : at + k] = low
            codes[1, T + 5 + k :] = 4  # the last valid k-mer is T + 5, in tile 0's halo
            codes[2, 2 * T - 96 : 5 * T + 160] = 4  # tiles 2-4 hold no valid base
            row_len[2] = MIN_L - 5
            row_len[3] = 2 * T + 700
        elif name == "every_window_kept":
            codes[0] = codes[1] = np.arange(MIN_L) % 2 * 3  # ATAT...
            row_len[1] = T + 300
            codes[2] = 0  # AAAA...
        else:
            codes[0, T + w - 2 : T + w - 2 + k] = low
            codes[1, 3 * T :] = 4
            row_len[2] = 2 * T + w
        sets.append((name, codes, row_len, k, w))
    if big:
        k = w = 19
        L = 70 * T + k + w - 2
        codes = codes_with_n_runs(rng, 64, L)
        codes[5] = 4  # a row of padding
        codes[9, L // 3 :] = 4
        row_len = np.full(64, L, np.int32)
        row_len[7] = 33 * T + 1000
        sets.append(("more_tiles_than_resident", codes, row_len, k, w))
    return sets


def index_batches(combined: str, k: int, w: int):
    """The index build's minimizers calls on the card (io/minimizer_index.py
    ``_build_device``): the reference's sequences grouped by padded length,
    as (packed, mask, row_len, L, cap) on the card, cap by the build's rule."""
    seqs = read_fasta(combined)[1]
    for ids, L in _row_batches([len(s) for s in seqs], k + w - 1):
        codes = np.full((len(ids), L), 4, dtype=np.uint8)
        for row, i in enumerate(ids):
            c = encode_seq(seqs[i])
            codes[row, : c.shape[0]] = c
        packed, mask, _ = pack_code_batch(codes)
        row_len = torch.tensor([len(seqs[i]) for i in ids], dtype=torch.int32, device="cuda")
        cap = max(4096, int(len(ids) * (L - k - w + 2) * 2.0 / (w + 1) * 1.35))
        yield torch.from_numpy(packed).cuda(), torch.from_numpy(mask).cuda(), row_len, L, cap


def minimizer_index_pass(combined: str, k: int, w: int, sms: int, clock_hz: float) -> dict:
    """``minimizers`` on the index build's batches with their row lengths:
    bit for bit against the plain version, the kernel's and the plain
    version's time and the bound, summed over the build's calls."""
    out = {"calls": 0, "ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, "batches": []}
    mb = []
    for packed, mask, row_len, L, cap in index_batches(combined, k, w):
        want = align_kernels.minimizers_torch(packed, mask, L, k, w, cap, row_len)
        n_kept = int(want[4])
        if n_kept > cap:  # the build's retry
            cap = n_kept
            want = align_kernels.minimizers_torch(packed, mask, L, k, w, cap, row_len)
        got = align_kernels.minimizers(packed, mask, L, k, w, cap, row_len)
        out["max_abs_err"] = max(out["max_abs_err"], check_equal("minimizers, index batch", got, want))
        del got, want
        hi, lo = extract_minimizers_torch(unpack_code_batch(packed, mask, L), k, w)[:2]
        in_row = torch.arange(hi.shape[1], device="cuda")[None, :] < (row_len.long() - k - w + 2)[:, None]
        live = int((in_row & ((hi != 0xFFFFFFFF) | (lo != 0xFFFFFFFF))).sum())
        del hi, lo, in_row
        mb.append((packed.numel() + mask.numel(), live, n_kept))
        out["batches"].append([packed.shape[0], L, int(row_len.sum()), live, cap, n_kept])
        out["calls"] += 1
        out["ms"] += cuda_ms(lambda: align_kernels.minimizers(packed, mask, L, k, w, cap, row_len))
        out["plain_ms"] += cuda_ms(
            lambda: align_kernels.minimizers_torch(packed, mask, L, k, w, cap, row_len), iters=1, warmup=1)
    out["bound_ms"], out["bound_by"] = minimizer_bound_ms(mb, k, sms, clock_hz)
    out["batches"].insert(0, ["rows", "L", "bases", "windows_with_valid_kmer", "cap", "kept"])
    return out


def phase_align_kernels(seed: int, cfg: RunConfig, index: MinimizerIndex, staged, combined: str,
                        sms: int, clock_hz: float) -> dict:
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    kn = align_kernels
    cases = {"minimizers": [], "anchors": [], "chains": []}
    err = dict.fromkeys(cases, 0.0)
    # minimizers at the edges: k and w at their limits, rows across tiles
    for k, w in ((19, 19), (15, 5), (16, 1), (32, 7), (31, 19), (5, 64)):
        for L in (k + w - 1, 2048 + k + w, 4099, 70_000):
            codes = codes_with_n_runs(rng, 6, L)
            codes[2] = 4  # all padding
            codes[3, L // 2:] = 4  # a short row
            codes[4, : min(L, k + w - 2)] = rng.integers(0, 4, min(L, k + w - 2))
            codes[4, k + w - 2:] = 4  # a row shorter than k + w - 1
            codes[5] = np.arange(L) % 2  # equal hashes in one window, cap overflow
            packed, mask, _ = pack_code_batch(codes)
            packed, mask = torch.from_numpy(packed).cuda(), torch.from_numpy(mask).cuda()
            lens = torch.tensor([L, L - 1, 0, L // 2, k + w - 2, L], dtype=torch.int32).cuda()
            for cap in (6 * L, max(1, L // 8)):
                for row_len in (None, lens):
                    got = kn.minimizers(packed, mask, L, k, w, cap, row_len)
                    want = kn.minimizers_torch(packed, mask, L, k, w, cap, row_len)
                    err["minimizers"] = max(err["minimizers"], check_equal(
                        f"minimizers k={k} w={w} L={L} cap={cap}", got, want))
                    cases["minimizers"].append([k, w, L, cap, row_len is not None, int(want[4])])
    # minimizers at its tile edges, with and without row lengths, at a cap
    # that holds every kept window and one that overflows
    for name, codes, row_len, k, w in minimizer_edge_sets(seed, big=True):
        packed, mask, L = pack_code_batch(codes)
        packed, mask = torch.from_numpy(packed).cuda(), torch.from_numpy(mask).cuda()
        for rl in (None, torch.from_numpy(row_len).cuda()):
            n = int(kn.minimizers_torch(packed, mask, L, k, w, 1, rl)[4])
            for cap in (n + 100, max(1, n // 3)):
                got = kn.minimizers(packed, mask, L, k, w, cap, rl)
                want = kn.minimizers_torch(packed, mask, L, k, w, cap, rl)
                err["minimizers"] = max(err["minimizers"], check_equal(
                    f"minimizers, set {name} cap={cap} row_len={rl is not None}", got, want))
                cases["minimizers"].append([name, *codes.shape, k, w, cap, rl is not None, n])
    # dynamic tile ids never change the order: 20 calls, one answer
    first = kn.minimizers(packed, mask, L, k, w, n, rl)
    for _ in range(19):
        check_equal(f"minimizers, set {name}, a repeated call", kn.minimizers(packed, mask, L, k, w, n, rl), first)
    # anchors and chains at the edges: a repetitive index, caps that overflow
    eidx, rows = edge_world(rng)
    eal = MinimizerAligner(eidx, device="cuda")
    L = 1 << 16
    codes = np.full((len(rows), L), 4, np.uint8)
    for r, q in enumerate(rows):
        codes[r, : len(q)] = encode_seq(q)
    packed, mask, _ = pack_code_batch(codes)
    packed, mask = torch.from_numpy(packed).cuda(), torch.from_numpy(mask).cuda()
    for cap in (8192, 1000):
        mz = kn.minimizers_torch(packed, mask, L, 19, 19, cap)
        for acap in (1 << 17, 3000):
            got = kn.anchors(*mz, eal._tables, MAX_OCC, 11, acap, len(rows), L)
            want = kn.sorted_anchors_torch(*mz, eal._tables, MAX_OCC, 11, acap, len(rows), L)
            err["anchors"] = max(err["anchors"], check_equal(f"anchors cap={cap} acap={acap}", got, want))
            cases["anchors"].append([cap, acap, int(mz[4]), int(want[3])])
            sorted_ = want[:3]
            for ccap in (1024, 7):
                got = kn.chains(*sorted_, 19, 3, 40, ccap)
                want_c = kn.chains_torch(*sorted_, 19, 3, 40, ccap)
                err["chains"] = max(err["chains"], check_equal(
                    f"chains cap={cap} acap={acap} ccap={ccap}", got, want_c))
                cases["chains"].append([cap, acap, ccap, int(want_c[1]), int(want_c[0][:, 3].max())])
    # anchors at its search's and sort's edges
    for name, genomes, codes, band_bits, acap in anchor_edge_sets(seed):
        _index, tables, mz, B, L = anchor_inputs(genomes, codes, device="cuda")
        lay = kn.sort_layout(tables, B, L, band_bits)
        for cut in (acap, max(1, acap // 7)):
            want = kn.sorted_anchors_torch(*mz, tables, MAX_OCC, band_bits, cut, B, L)
            err["anchors"] = max(err["anchors"], check_equal(
                f"anchors, set {name} acap={cut}", kn.anchors(*mz, tables, MAX_OCC, band_bits, cut, B, L), want))
            cases["anchors"].append([name, B, L, band_bits, cut, int(mz[4]), int(want[3]), lay.bits,
                                     lay.passes])
    # chains at its tile edges
    for name, key, qpos, rpos, cargs in chain_edge_sets(seed, longest=True):
        cin = tuple(torch.from_numpy(x).cuda() for x in (key, qpos, rpos))
        want_c = kn.chains_torch(*cin, *cargs)
        err["chains"] = max(err["chains"], check_equal(f"chains, set {name}", kn.chains(*cin, *cargs), want_c))
        cases["chains"].append([name, len(key), cargs[3], int(want_c[1]), int(want_c[0][:, 3].max())])
    # the main path's shapes: the 16 staged gut batches against the gut index
    aln = MinimizerAligner(index, AlignerConfig(batch_pad=cfg.align_batch_pad), device="cuda")
    k, w = index.k, index.w
    stats = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": None} for name in cases}
    stats["anchors"].update(library_ms=0.0, library="torch.sort(stable=True) of the filled "
                            "prefix's keys and the two gathers of qpos and rpos by its permutation")
    shapes, mb, ab, cb = [], [], [], []
    for packed, mask, B, L in staged.device:
        NW, cap = aln._minimizer_cap(B, L)
        acap, ccap = aln._device_caps(B, NW, cap)
        mz = kn.minimizers(packed, mask, L, k, w, cap)
        err["minimizers"] = max(err["minimizers"], check_equal(
            "minimizers, staged batch", mz, kn.minimizers_torch(packed, mask, L, k, w, cap)))
        args = (*mz, aln._tables, aln.cfg.max_occ, aln.cfg.band_bits, acap, B, L)
        an = kn.anchors(*args)
        err["anchors"] = max(err["anchors"], check_equal("anchors, staged batch", an,
                                                         kn.sorted_anchors_torch(*args)))
        sorted_ = an[:3]
        cargs = (*sorted_, k, aln.cfg.min_cnt, aln.cfg.min_mlen, ccap)
        ch = kn.chains(*cargs)
        err["chains"] = max(err["chains"], check_equal("chains, staged batch", ch, kn.chains_torch(*cargs)))
        n_kept, n_anchors, n_chains = int(mz[4]), int(an[3]), int(ch[1])
        if n_kept > cap or n_anchors > acap or n_chains > ccap:
            raise AssertionError(f"a staged batch overflowed: {n_kept, cap, n_anchors, acap, n_chains, ccap}")
        hi, lo = extract_minimizers_torch(unpack_code_batch(packed, mask, L), k, w)[:2]
        live = int(((hi != 0xFFFFFFFF) | (lo != 0xFFFFFFFF)).sum())
        mb.append((packed.numel() + mask.numel(), live, n_kept))
        ab.append((n_kept, *search_stats(mz[0][:n_kept], aln._tables), n_anchors, acap))
        # the part of the function a library sort can do: the filled prefix
        # of the unsorted anchors, sorted stably, its payload gathered
        fill = min(n_anchors, acap)
        ukey, uqpos, urpos = (x[:fill] for x in kn.anchors_torch(
            *mz, aln._tables.uniq, aln._tables.roff, aln._tables.ps, aln.cfg.max_occ,
            aln.cfg.band_bits, acap, B, L)[:3])

        def library():
            perm = torch.sort(ukey, stable=True)[1]
            return uqpos[perm], urpos[perm]

        cb.append((n_anchors, n_chains))
        # the longest chain of valid anchors: every chain passes min_cnt 1, min_mlen 0
        longest = int(kn.chains_torch(*sorted_, k, 1, 0, acap)[0][:, 3].max())
        shapes.append([B, L, live, cap, n_kept, acap, n_anchors, ccap, n_chains, longest])
        stats["minimizers"]["ms"] += cuda_ms(lambda: kn.minimizers(packed, mask, L, k, w, cap))
        stats["minimizers"]["plain_ms"] += cuda_ms(
            lambda: kn.minimizers_torch(packed, mask, L, k, w, cap), iters=3, warmup=1)
        stats["anchors"]["ms"] += cuda_ms(lambda: kn.anchors(*args))
        stats["anchors"]["plain_ms"] += cuda_ms(lambda: kn.sorted_anchors_torch(*args), iters=3, warmup=1)
        stats["anchors"]["library_ms"] += cuda_ms(library)
        stats["chains"]["ms"] += cuda_ms(lambda: kn.chains(*cargs))
        stats["chains"]["plain_ms"] += cuda_ms(lambda: kn.chains_torch(*cargs), iters=3, warmup=1)
    stats["minimizers"]["index_pass"] = minimizer_index_pass(combined, k, w, sms, clock_hz)
    err["minimizers"] = max(err["minimizers"], stats["minimizers"]["index_pass"].pop("max_abs_err"))
    U = int(aln._tables.uniq.numel())
    sizes = torch.diff(aln._tables.bucket[:-1])
    for name, (bound, by) in (("minimizers", minimizer_bound_ms(mb, k, sms, clock_hz)),
                              ("anchors", anchor_bound_ms(ab, sms, clock_hz)),
                              ("chains", chain_bound_ms(cb, sms, clock_hz))):
        stats[name].update(bound_ms=bound, bound_by=by, max_abs_err=err[name])
    emit("align_kernels", t0, cases=cases, identical=True, unique_hashes=U,
         bucket_table={"bits": int(sizes.numel()).bit_length() - 1, "shift": aln._tables.shift,
                       "largest_bucket": int(sizes.max()),
                       "worst_steps": int(sizes.max()).bit_length(),
                       "empty_buckets": int((sizes == 0).sum())},
         anchor_search=[["kept", "loads", "bucket_entries", "unique_entries", "anchors", "acap"], *ab],
         anchor_layout=kn.sort_layout(aln._tables, *staged.device[0][2:], aln.cfg.band_bits)._asdict(),
         minimizer_ops=minimizer_ops(k), per_pass=stats,
         batches=[["rows", "L", "windows_with_valid_kmer", "cap", "kept", "acap", "anchors",
                   "ccap", "chains", "longest_chain"], *shapes])
    return stats


LCA_BUCKETS = (8, 32, 128, 512, 2048)  # hymet_tpu_torch.ops.lca.DEFAULT_BUCKETS


def lca_edge_sets(seed: int = 0, big_q: int = 4) -> list:
    """Hit batches for ``weighted_lca`` at every bucket size H, as (name,
    rows int32 [Q, H], weights float64 [Q, H], rank table int32 [T, 8]).
    The table has few names at the top ranks (many hits share a name, so
    the order of the adds shows in the bits), an all-zero row (a taxid
    missing from the hierarchy), a row with no name at rank 0 but names
    below, a row with a gap at rank 3, rows 8 deep, and pairs of rows that
    differ first at rank 0 and at rank 3. Each H has 16 queries (`big_q`
    at H = 2048): random hit counts padded with -1 and weights spread over
    four decades, the first query full; then, as many as fit after one
    random query: ties on purpose at rank 0 and at rank 3 (equal sums under
    two names, from dyadic weights in different numbers of hits), a
    padding query (all -1), a tie whose later-seen name's hit comes first,
    all hits on the all-zero row, all on the row without a rank-0 name,
    named hits of weight 0 (a zero total), one hit, a stop at rank 3, and
    one taxid in every slot."""
    rng = np.random.default_rng(seed)
    T = 64
    table = np.zeros((T, 8), np.int32)
    for t in range(T - 5):
        for r in range(int(rng.integers(1, 9))):
            table[t, r] = 1 + 100 * r + int(rng.integers(0, 2 + 3 * r))
    table[1, 0], table[1, 1:] = 0, table[5, 1:] | 1  # no name at rank 0, names below
    table[2, 3] = 0  # a gap at rank 3
    table[3] = table[4] = 1 + 100 * np.arange(8)  # 8 deep
    zero, a, b, c, d = T - 5, T - 4, T - 3, T - 2, T - 1  # row `zero` stays all zero
    table[a], table[b] = 11 + 100 * np.arange(8), 12 + 100 * np.arange(8)  # differ at rank 0
    table[c] = table[d] = 13 + 100 * np.arange(8)
    table[d, 3:] += 50  # c and d differ from rank 3 on
    sets = []
    for H in LCA_BUCKETS:
        Q = 16 if H < 2048 else big_q
        rows = rng.integers(0, T, (Q, H)).astype(np.int32)
        weights = rng.random((Q, H)) * 10.0 ** rng.uniform(-2, 2, (Q, H))
        n = rng.integers(1, H + 1, Q)
        n[0] = H  # a full row
        special = [  # the first ones go into the small batches too
            ([a, b, a, b], [1.5, 3.0, 1.5, 0.0]),  # tie at rank 0
            ([c, d, 3, c, d], [2.0, 0.5, 0.125, 0.0, 1.5]),  # tie at rank 3
            (np.full(H, -1), weights[0]),  # a padding query
            ([b, a, a, b, a], [0.5, 2.0, 0.75, 2.25, 0.0]),  # tie, the later name's hit first
            (np.full(H, zero), weights[0]),  # the all-zero row
            (np.ones(H), weights[0]),  # no name at rank 0
            ([a, c, 3], [0.0, 0.0, 0.0]),  # named, weight 0
            ([4], [0.7]),  # one hit
            ([2, zero, 2], [1.0, 3.0, 2.0]),  # stops at the gap: depth 3
            (np.full(H, 3), weights[1]),  # one taxid in every slot
        ]
        start = max(1, Q - len(special))
        for i, (r_, w_) in zip(range(start, Q), special):
            m = min(H, len(r_))
            rows[i, :m], weights[i, :m], n[i] = np.asarray(r_)[:m], np.asarray(w_)[:m], m
        pad = np.arange(H)[None, :] >= n[:, None]
        rows[pad] = -1  # padding slots keep their weights: -1 ignores them
        sets.append((f"H={H}", rows, weights, table))
    return sets


def lca_bound_ms(batches, rank_table: np.ndarray, sms: int, clock_hz: float) -> tuple:
    """(least time in ms, what bounds it) for ``weighted_lca`` over bucket
    batches given as (rows int32 [Q, H], n_chosen [Q]), with the rank table
    of the run. A query evaluates ranks 0 .. min(n_chosen, 7): the ranks it
    chose and the one that stopped it.

    - bytes: 12 a valid hit (row and weight); 4 a rank-table entry, each
      (row, rank) pair that some query's valid hits reach, read once; 44 a
      query written (8 names, the depth, the confidence);
    - operations: float64 adds, per query and rank evaluated: the per-name
      sums need n_named - n_distinct adds and the named total n_named - 1;
      a chosen rank adds a quotient and a product (counted 1 each)."""
    nbytes = fp64 = 0
    for rows, n_chosen in batches:
        Q, _H = rows.shape
        reached = np.minimum(n_chosen.astype(np.int64) + 1, 8)
        entries = set()
        for q in range(Q):
            hits = rows[q][rows[q] >= 0]
            if hits.size == 0:
                continue
            for r in range(int(reached[q])):
                entries.update(zip(hits.tolist(), [r] * hits.size))
                names = rank_table[hits, r]
                named = names[names != 0]
                if named.size:
                    fp64 += 2 * named.size - np.unique(named).size - 1
                fp64 += 2 * (r < n_chosen[q])
        nbytes += 12 * int((rows >= 0).sum()) + 44 * Q
        nbytes += 4 * len(entries)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = fp64 / FP64_PER_CLK / sms / clock_hz * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def run_config(tmp: str) -> RunConfig:
    """The whole run on the gut sample as a user would set it up: the
    in-repo sketch DBs, genomes, accession table and taxonomy; RunConfig
    defaults otherwise."""
    return RunConfig(
        input_fasta=CONTIGS, outdir=os.path.join(tmp, "run"),
        cache_root=os.path.join(tmp, "run_cache"), taxonomy_dir=os.path.join(WORLD, "taxonomy"),
        sketch_dbs=[os.path.join(WORLD, f"{label}.npz") for label in DB_LABELS],
        genome_catalog=GENOMES, seqid2taxid=os.path.join(WORLD, "acc2taxid.tsv"))


def phase_run(tmp: str) -> dict:
    """ClassificationRun.execute on the gut sample, on the card: each
    stage's seconds, every kernel launched, no first-hit fallback, and a
    classified_sequences.tsv byte-identical to a CPU re-classification of
    the run's own resultados.paf. Returns what the LCA phase needs."""
    t0 = time.perf_counter()
    cfg = run_config(tmp)
    torch.cuda.synchronize()
    zero_launches()
    t = time.perf_counter()
    run = ClassificationRun(cfg, device="cuda")
    classified = run.execute()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = all_launches()
    missing = [k for k, n in launches.items() if n <= 0 and k not in RUN_IDLE]
    if missing:
        raise AssertionError(f"kernels not launched by execute: {missing} ({launches})")
    if run.fallback_ran:
        raise AssertionError("the first-hit fallback ran: the weighted LCA did not classify")
    (key,) = os.listdir(cfg.cache_root)
    paf = os.path.join(cfg.outdir, "work", "resultados.paf")
    taxonomy = os.path.join(cfg.cache_root, key, "detailed_taxonomy.tsv")
    hierarchy = run._hierarchy_path()
    cpu_tsv = os.path.join(tmp, "classified_cpu.tsv")
    t = time.perf_counter()
    classify_paf(paf, taxonomy, hierarchy, cpu_tsv, device="cpu")
    cpu_s = time.perf_counter() - t
    if not filecmp.cmp(classified, cpu_tsv, shallow=False):
        raise AssertionError("classified_sequences.tsv differs from the CPU re-classification")
    # the classification's LCA batches, as classify_paf makes them
    qmap, counts = parse_paf_for_classification(paf)
    tw = taxid_weights(qmap, counts, IdentifierMap.from_detailed_taxonomy(taxonomy))
    rank_table, names, batches = lca_inputs(tw, load_hierarchy_vectors(hierarchy))
    with open(classified, newline="") as f:
        rows = f.read().split("\r\n")[1:-1]
    levels = {}
    for row in rows:
        level = row.split("\t")[2]
        levels[level] = levels.get(level, 0) + 1
    prof = profile_run(lambda: classify_paf(paf, taxonomy, hierarchy, os.path.join(tmp, "again.tsv"),
                                            device="cuda"))
    with open(paf) as f:
        n_records = sum(1 for _ in f)
    cami = os.path.join(cfg.outdir, "hymet.contigs.cami.tsv")
    emit("run", t0, execute_s=run_s, stage_s=run.timings, launches=launches, fallback_ran=False,
         paf_records=n_records, classified_rows=len(rows), levels=levels,
         tsv_identical_to_cpu=True, cpu_classify_s=cpu_s,
         lca_buckets=[[int(r.shape[0]), int(r.shape[1]), int(len(q))] for q, r, _w in batches],
         rank_table_rows=int(rank_table.shape[0]), names=len(names),
         cami_rows=sum(1 for ln in open(cami) if not ln.startswith(("#", "@"))),
         classify_profile=prof)
    return {"launches": launches["lca"], "classify_s": run.timings["classify"],
            "rank_table": rank_table, "batches": batches, "execute_s": run_s,
            "stage_s": run.timings, "outdir": cfg.outdir}


def phase_lca(seed: int, gut: dict, sms: int, clock_hz: float) -> dict:
    """``weighted_lca``'s kernel against ``weighted_lca_torch`` on the card,
    bit for bit: chip_smoke's edge sets at H = 8 .. 2048 (two seeds) and
    the gut classification's bucket batches; then the kernel's time over
    one gut classification's batches, the plain version's and the bound."""
    t0 = time.perf_counter()
    cases, err = [], 0.0
    for s in (seed, seed + 1):
        for name, *arrays in lca_edge_sets(s, big_q=16):
            args = [torch.from_numpy(x).cuda() for x in arrays]
            want = lca.weighted_lca_torch(*args)
            err = max(err, check_equal(f"lca, seed {s}, {name}", lca.weighted_lca(*args), want))
            cases.append([s, name, *arrays[0].shape, np.bincount(want[1].cpu().numpy(), minlength=9).tolist()])
    table = torch.from_numpy(gut["rank_table"]).cuda()
    batches = [(torch.from_numpy(r).cuda(), torch.from_numpy(w).cuda()) for _q, r, w in gut["batches"]]
    depths = []
    for rows, w in batches:
        want = lca.weighted_lca_torch(rows, w, table)
        err = max(err, check_equal(f"lca, gut batch {tuple(rows.shape)}",
                                   lca.weighted_lca(rows, w, table), want))
        depths.append(want[1].cpu().numpy())
    ms = sum(cuda_ms(lambda: lca.weighted_lca(rows, w, table)) for rows, w in batches)
    plain_ms = sum(cuda_ms(lambda: lca.weighted_lca_torch(rows, w, table), iters=3, warmup=1)
                   for rows, w in batches)
    bound, by = lca_bound_ms([(r, d) for (_q, r, _w), d in zip(gut["batches"], depths)],
                             gut["rank_table"], sms, clock_hz)
    stats = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
             "library_ms": None, "max_abs_err": err}
    emit("lca", t0, cases=cases, identical=True, gut_batches=[list(r.shape) for r, _w in batches],
         launches_per_classification=len(batches), share_of_classify=ms / 1e3 / gut["classify_s"],
         **stats)
    return stats


# by stage of the run, each kernel its trace is held to: its wrapper's
# name and the kernel that each of the wrapper's calls launches once
PROFILE_STAGES = {
    "screen": {"screen_count": "screen_count_kernel"},
    "align": {"minimizers": "minimizer_tile_kernel", "anchors": "anchor_search_kernel",
              "chains": "chain_tile_kernel"},
    "classify": {"lca": "lca_kernel"},
}
PROFILE_FILES = ("work/selected_genomes.txt", "work/resultados.paf", "classified_sequences.tsv",
                 "hymet.contigs.cami.tsv")


def trace_kernels(path: str, stage: str) -> tuple:
    """A stage's gzipped Chrome trace: its kernel activities by name, and
    how many of the CUDA runtime's launches, copies and memsets inside
    the ``stage <name>`` span have no device record (matched by
    correlation id)."""
    with gzip.open(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    (span,) = [e for e in events
               if e.get("cat") == "user_annotation" and e["name"] == f"stage {stage}"]
    shown = {e["args"]["correlation"] for e in events
             if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    unmatched = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                    and e["name"].startswith(("cudaLaunch", "cudaMemcpy", "cudaMemset"))
                    and e["ts"] >= span["ts"] and e["args"]["correlation"] not in shown)
    return Counter(e["name"] for e in events if e.get("cat") == "kernel"), unmatched


def phase_profile(tmp: str, gut: dict) -> dict:
    """Phase 8's run again under HYMET_PROFILE=1, with a fresh outdir and a
    cold cache (so the align stage builds its index on the card): each
    stage's trace, its path and size; each kernel's launches in a stage
    (the wrappers' counts, read around each stage) against the activities
    its trace shows, which must be equal; no launch outside a stage; the
    selected genomes, PAF, classification and CAMI files equal to phase
    8's; the run's seconds with and without the profiler."""
    t0 = time.perf_counter()
    cfg = run_config(tmp)
    cfg.outdir = os.path.join(tmp, "profile_run")
    cfg.cache_root = os.path.join(tmp, "profile_cache")
    timed, per_stage = ClassificationRun._timed, {}

    def counted(self, name, fn):
        before = all_launches()
        try:
            return timed(self, name, fn)
        finally:
            after = all_launches()
            per_stage[name] = {k: n - before[k] for k, n in after.items() if n != before[k]}

    with mock.patch.dict(os.environ, {"HYMET_PROFILE": "1"}), \
            mock.patch.object(ClassificationRun, "_timed", counted):
        torch.cuda.synchronize()
        zero_launches()
        t = time.perf_counter()
        run = ClassificationRun(cfg, device="cuda")
        run.execute()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
    total = {k: n for k, n in all_launches().items() if n}
    in_stages = Counter()
    for counts in per_stage.values():
        in_stages.update(counts)
    if dict(in_stages) != total:
        raise AssertionError(f"launches outside a traced stage: {total} in all, "
                             f"{dict(in_stages)} inside the stages")
    for name in PROFILE_FILES:
        if not filecmp.cmp(os.path.join(cfg.outdir, name), os.path.join(gut["outdir"], name),
                           shallow=False):
            raise AssertionError(f"the profiled run's {name} differs from phase 8's")
    root = os.path.join(cfg.outdir, "logs", "profile")
    traces, rows, launches, traced = {}, [], Counter(), Counter()
    for stage in sorted(os.listdir(root)):
        (path,) = glob.glob(os.path.join(root, stage, "plugins", "profile", "*", "*.trace.json.gz"))
        kernels, unmatched = trace_kernels(path, stage)
        traces[stage] = {"path": os.path.relpath(path, cfg.outdir),
                         "bytes": os.path.getsize(path), "kernel_activities": sum(kernels.values()),
                         "runtime_calls_without_device_record": unmatched}
        for wrapper, kernel in PROFILE_STAGES.get(stage, {}).items():
            n = per_stage[stage].get(wrapper, 0)
            shown = sum(c for name, c in kernels.items() if kernel in name)
            rows.append([stage, wrapper, n, shown])
            launches[wrapper] += n
            traced[wrapper] += shown
    if set(traces) != set(run.timings):
        raise AssertionError(f"stages {sorted(run.timings)}, traces {sorted(traces)}")
    short = [row for row in rows if row[2] <= 0 or row[3] != row[2]]
    if short:
        raise AssertionError(f"a stage's trace does not show every launch of its kernels "
                             f"([stage, kernel, launched, traced]): {short}")
    emit("profile", t0, execute_s=run_s, unprofiled_execute_s=gut["execute_s"],
         stage_s=run.timings, unprofiled_stage_s=gut["stage_s"], traces=traces,
         launched_traced=rows, launches_by_stage=per_stage, files_equal=list(PROFILE_FILES),
         nvidia_smi=nvidia_smi("name,power.limit"))
    return {"launches": dict(launches), "traced": dict(traced)}


SKETCH_WAVE = 4096  # windows a block of csrc/bottom_sketch.cu takes at a time
SKETCH_CHUNK = 16 * SKETCH_WAVE  # windows a chunk block owns


def bottom_sketch_edge_sets(seed: int = 0) -> list:
    """Hash batches for ``bottom_sketch`` as (name, hash int64 [B, n], valid
    bool [B, n], s, segments): s = 1, 7 (not a power of two), 1000, above a
    wave and the shared-memory lists (5000) and above the windows; one
    value over three waves (poly-A: n = 1); a small pool of values
    repeated across waves and rows; an all-invalid row beside valid ones; a
    valid hash equal to PAD_HASH (-1), and one that is invalid; n at a
    wave's edges (4095, 4096, 4097, 8193; and 4097 with every window kept)
    and at a chunk's (65,535 .. 65,537, every window kept); 37 waves in one
    row; pooled segments of 2, 1 and 3 rows; the values at the sign edge
    (0, -1, INT64_MAX, INT64_MIN), whose order shows a signed compare; keys
    in descending order over two chunks (each wave below the last: the
    running threshold's worst case); a pool of 1100 values at s = 1000 (the
    s-th key tied many times over); and a first chunk of 50 small keys
    beside a full second one (a chunk of fewer than s keys publishes no
    bound)."""
    rng = np.random.default_rng(seed)

    def rand(B, n):
        return rng.integers(-(2**63), 2**63 - 1, (B, n), dtype=np.int64, endpoint=True)

    def dense(B, n, p=1.0):
        return rng.random((B, n)) < p

    T, C = SKETCH_WAVE, SKETCH_CHUNK
    sets = [
        ("s=1", rand(4, 2 * T + 9), dense(4, 2 * T + 9, 0.5), 1, None),
        ("s=7", rand(3, T + 100), dense(3, T + 100, 0.9), 7, None),
        ("poly-A", np.full((2, 3 * T), 0x1234567, np.int64), dense(2, 3 * T), 1000, None),
        ("pool", rng.integers(-1500, 1500, (3, 3 * T + 5)).astype(np.int64),
         dense(3, 3 * T + 5, 0.97), 1000, None),
        ("s>tile", rand(2, 5 * T + 3), dense(2, 5 * T + 3), 5000, None),
        ("s>windows", rand(3, 50), dense(3, 50), 1000, None),
        ("37 tiles", rand(1, 37 * T - 11), dense(1, 37 * T - 11, 0.8), 300, None),
        ("segments", rng.integers(-50_000, 50_000, (6, T + 500)).astype(np.int64),
         dense(6, T + 500, 0.95), 300, [2, 1, 3]),
        ("one segment", rand(4, 9), dense(4, 9), 20, [4]),
    ]
    for n in (T - 1, T, T + 1, 2 * T + 1):
        sets.append((f"n={n}", rand(2, n), dense(2, n, 0.99), 1000, None))
    h, v = rand(3, T + 7), dense(3, T + 7)
    v[1] = False  # an all-invalid row
    h[0, 3], h[2, T + 2], v[2, T + 2] = -1, -1, False  # a real PAD_HASH, an invalid one
    sets.append(("pad and invalid", h, v, 10_000, None))
    edge = np.array([[0, -1, 2**63 - 1, -(2**63), 1, -2, 5, 0]], np.int64)
    sets.append(("sign edges", edge, np.ones_like(edge, bool), 6, None))
    sets.append(("n=4097, all kept", rand(2, T + 1), dense(2, T + 1, 0.99), 5000, None))
    for n in (C - 1, C, C + 1):
        sets.append((f"n={n}, all kept", rand(1, n), dense(1, n, 0.99), C + 10, None))
    n = 2 * C + 999
    keys = -(2**63) + (np.arange(n, 0, -1, dtype=np.int64) << 40)  # descending keys
    sets.append(("descending", np.stack([keys, keys >> 3]) ^ np.int64(-(2**63)),
                 dense(2, n, 0.98), 1000, None))
    sets.append(("ties at the s-th key", rng.integers(0, 1100, (2, C + 3000)).astype(np.int64),
                 dense(2, C + 3000, 0.9), 1000, None))
    h, v = rand(1, C + 4000), dense(1, C + 4000)
    v[0, 50:C] = False
    h[0, :50] = np.arange(50)  # the row's 50 smallest hashes, alone in chunk 0
    sets.append(("sparse first chunk", h, v, 1000, None))
    return sets


def sketch_codes_edge_sets(seed: int = 0) -> list:
    """Code batches for ``sketch_codes`` as (name, codes uint8 [B, L], k,
    s): s = 1, 7, 1000, 5000, 10,000 (lists in device memory) and above the
    windows; a poly-A row and a low-complexity row (a 37-base repeat) with
    fewer than s distinct keys, an all-N row and a half-N row beside random
    ones; L at a wave's edges (4095 .. 4097 windows) and a chunk's (65,535
    .. 65,537), every window kept; many short rows beside one much longer
    (padded with N, as the DB build pads a batch); L a multiple of 16 (the
    16-byte loads); N runs; k = 15, 21 and 31."""
    rng = np.random.default_rng(seed)

    def rand(B, L):
        return rng.integers(0, 4, (B, L)).astype(np.uint8)

    W, C = SKETCH_WAVE, SKETCH_CHUNK
    mixed = rand(6, 9000)
    mixed[0] = 0  # poly-A
    mixed[1] = np.resize(rand(1, 37)[0], 9000)  # low complexity
    mixed[2] = 4  # all N
    mixed[3, ::2] = 4  # half N
    mixed[4, 4000:4100] = 4
    sets = [
        ("s=1", rand(4, 5000), 21, 1),
        ("s=7, k=15", rand(3, W + 100), 15, 7),
        ("s=1000, k=31, N runs", codes_with_n_runs(rng, 3, 20_000), 31, 1000),
        ("s=5000", rand(2, 30_000), 21, 5000),
        ("s=10000, two chunks", rand(2, C + 4000), 21, 10_000),
        ("s>windows", rand(3, 300), 21, 1000),
        ("poly-A, repeat, all-N, half-N", mixed, 21, 1000),
        ("poly-A, repeat, all-N, half-N, k=15", mixed, 15, 1000),
        ("L%16=0", rand(2, 2 * W), 21, 500),
    ]
    for n in (W - 1, W, W + 1):
        sets.append((f"n={n}, all kept", rand(2, n + 20), 21, W + 10))
    for n in (C - 1, C, C + 1):
        sets.append((f"n={n}, all kept", rand(1, n + 20), 21, C + 10))
        sets.append((f"n={n}", rand(2, n + 20), 21, 1000))
    long = np.full((40, 200_000), 4, np.uint8)
    long[:, :2000] = rand(40, 2000)
    long[7] = rand(1, 200_000)[0]
    sets.append(("one row much longer", long, 21, 1000))
    return sets


def sketch_bound_ms(batches) -> tuple:
    """(least time in ms, what bounds it) for ``bottom_sketch`` over batches
    given as (B, n, segments, s): each window's hash (8 B) and valid flag
    (1 B) read once, each segment's s hashes (8 B) and count (4 B) written
    once; bytes bound it (a selection does a few operations a window)."""
    nbytes = sum(9 * B * n + G * (8 * s + 4) for B, n, G, s in batches)
    return nbytes / PEAK_BYTES_S * 1e3, "bytes"


def sketch_codes_bound_ms(batches, k: int, sms: int, clock_hz: float) -> tuple:
    """(least time in ms, what bounds it) for ``sketch_codes`` over batches
    given as (B, L, valid windows, s): each code (1 B) read once, each row's
    s hashes (8 B) and count (4 B) written once; every valid window hashed
    (:func:`window_ops`, as ``kmer_hashes`` counts a window; an invalid
    window needs no hash), and the selection's few operations a window not
    counted."""
    nbytes = sum(B * L + B * (8 * s + 4) for B, L, _v, s in batches)
    alu, mad = window_ops(k, screen=False)
    n = sum(v for _B, _L, v, _s in batches)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops_ms(n * alu, n * mad, sms, clock_hz)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def db_files(label: str) -> list:
    """A committed sketch DB's genome files, in the order of its rows."""
    names = load_sketch_db(os.path.join(WORLD, f"{label}.npz")).names
    return [os.path.join(GENOMES, "_".join(n.split("_")[:2]), n) for n in names]


def same_db(got: SketchDB, want: SketchDB, what: str) -> None:
    if (got.k, got.sketch_size, got.names) != (want.k, want.sketch_size, want.names):
        raise AssertionError(f"{what}: k, sketch size or names differ")
    for f in ("hashes", "n_hashes", "lengths"):
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"{what}: {f} differs from the committed DB")


def build_batches(paths: list) -> list:
    """The DB build's batches of code rows (one a genome, its sequences
    joined by an N), as ``sketch_rows`` forms them on the card."""
    rows = [sketchdb.genome_row([encode_seq(seq) for _, seq in iter_fasta(p)]) for p in paths]
    return [sketchdb.pad_rows([rows[i] for i in batch])
            for batch in sketchdb.code_batches(rows, 21, sketchdb.BUILD_WINDOWS["cuda"])]


def unique_pairs(h: torch.Tensor, v: torch.Tensor):
    """(row, key) pairs of the valid windows, for the library call
    ``torch.unique(pairs, dim=0)``: each row's distinct keys, sorted."""
    rows = torch.arange(h.shape[0], device=h.device)[:, None].expand_as(h)
    return torch.stack([rows[v], (h ^ SIGN)[v]], dim=1)


PIECE_WINDOWS = 300_000  # a window budget that puts every in-repo genome up in pieces


def phase_db(tmp: str, sms: int, clock_hz: float) -> dict:
    t0 = time.perf_counter()
    os.environ["HYMET_PLATFORM"] = "cuda"
    out_dir = os.path.join(tmp, "db")
    os.makedirs(out_dir)
    files = {label: db_files(label) for label in DB_LABELS}
    committed = {label: load_sketch_db(os.path.join(WORLD, f"{label}.npz")) for label in DB_LABELS}
    torch.cuda.synchronize()
    zero_launches()
    cli_s = {}
    for label in DB_LABELS:
        for ext in (".npz", ".msh"):
            t = time.perf_counter()
            rc = cli.main(["sketch", *files[label], "--out", os.path.join(out_dir, label + ext)])
            cli_s[label + ext] = time.perf_counter() - t
            if rc != 0:
                raise AssertionError(f"sketch {label}{ext} exited {rc}")
    launches = all_launches()
    if launches["sketch_codes"] <= 0 or launches["kmer_hash"] or launches["bottom_sketch"]:
        raise AssertionError(f"the DB build did not go through sketch_codes alone: {launches}")
    for label in DB_LABELS:
        for ext in (".npz", ".msh"):
            same_db(load_sketch_db(os.path.join(out_dir, label + ext)), committed[label],
                    f"{label}{ext}")
    # genomes past the window budget go up in pieces, folded by bottom_sketch
    ref = committed["sketch1"]
    with mock.patch.dict(sketchdb.BUILD_WINDOWS, cuda=PIECE_WINDOWS):
        torch.cuda.synchronize()
        zero_launches()
        same_db(build_sketch_db(files["sketch1"][:6], 21, 1000, device="cuda"),
                SketchDB(k=21, sketch_size=1000, hashes=ref.hashes[:6], n_hashes=ref.n_hashes[:6],
                         names=ref.names[:6], lengths=ref.lengths[:6]), "sketch1[:6] in pieces")
        pieces = all_launches()
    if pieces["sketch_codes"] <= 0 or pieces["bottom_sketch"] <= 0 or pieces["kmer_hash"]:
        raise AssertionError(f"the build in pieces did not fold through bottom_sketch: {pieces}")
    # the build's split, in a build of its own (its steps end in a synchronize),
    # and its peak device memory
    split = {}
    for label in DB_LABELS:
        timings = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        same_db(build_sketch_db(files[label], 21, 1000, device="cuda", timings=timings),
                committed[label], f"{label} (timed build)")
        split[label] = {"total_s": time.perf_counter() - t, **timings,
                        "peak_bytes": torch.cuda.max_memory_allocated()}
    # on each build's batches: sketch_codes, and the earlier route's two
    # kernels (kmer_hash, then bottom_sketch on its hashes), each bit for bit
    # against its plain version, timed and bounded
    stats = {"sketch_codes": {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0},
             "kmer_hash": {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0},
             "bottom_sketch": {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0.0}}
    shapes, sketch_batches, codes_batches = [], [], []
    for label in DB_LABELS:
        for codes in build_batches(files[label]):
            g = torch.from_numpy(codes).cuda()
            c = stats["sketch_codes"]
            want = sketch_kernels.sketch_codes_torch(g, 21, 1000)
            c["max_abs_err"] = max(c["max_abs_err"], check_equal(
                f"sketch_codes, {label}", sketch_kernels.sketch_codes(g, 21, 1000), want))
            c["ms"] += cuda_ms(lambda: sketch_kernels.sketch_codes(g, 21, 1000), iters=10, warmup=2)
            c["plain_ms"] += cuda_ms(lambda: sketch_kernels.sketch_codes_torch(g, 21, 1000),
                                     iters=2, warmup=1)
            k = stats["kmer_hash"]
            k["max_abs_err"] = max(k["max_abs_err"], check_kernel(g, 21))
            k["ms"] += cuda_ms(lambda: hash_kernels.kmer_hashes(g, 21), iters=5, warmup=2)
            k["plain_ms"] += cuda_ms(lambda: kmer_hashes_torch(g, 21), iters=2, warmup=1)
            h, v = hash_kernels.kmer_hashes(g, 21)
            b = stats["bottom_sketch"]
            got = sketch_kernels.bottom_sketch(h, v, 1000)
            b["max_abs_err"] = max(b["max_abs_err"], check_equal(f"bottom_sketch, {label}", got,
                                                                 want))
            b["ms"] += cuda_ms(lambda: sketch_kernels.bottom_sketch(h, v, 1000), iters=10, warmup=2)
            b["plain_ms"] += cuda_ms(lambda: sketch_kernels.bottom_sketch_torch(h, v, 1000),
                                     iters=2, warmup=1)
            pairs = unique_pairs(h, v)
            b["library_ms"] += cuda_ms(lambda: torch.unique(pairs, dim=0, sorted=True),
                                       iters=2, warmup=1)
            valid = int(v.sum())
            shapes.append([label, *codes.shape, valid])
            sketch_batches.append((*h.shape, h.shape[0], 1000))
            codes_batches.append((*codes.shape, valid, 1000))
            del g, h, v, pairs, got, want
    stats["sketch_codes"]["bound_ms"], stats["sketch_codes"]["bound_by"] = sketch_codes_bound_ms(
        codes_batches, 21, sms, clock_hz)
    stats["kmer_hash"]["bound_ms"], stats["kmer_hash"]["bound_by"] = hash_bound_ms(
        [(B, L) for _label, B, L, _v in shapes], 21, sms, clock_hz)
    stats["bottom_sketch"]["bound_ms"], stats["bottom_sketch"]["bound_by"] = sketch_bound_ms(
        sketch_batches)
    earlier_route_ms = stats["kmer_hash"]["ms"] + stats["bottom_sketch"]["ms"]
    # the run and the legacy run, as a user types them, on the .msh DBs and
    # phase 8's cache
    cfg8 = run_config(tmp)
    argv = ["--contigs", CONTIGS, "--taxonomy-dir", cfg8.taxonomy_dir, "--genome-catalog",
            GENOMES, "--seqid2taxid", cfg8.seqid2taxid, "--cache-root", cfg8.cache_root,
            "--cand-max", str(cfg8.cand_max)]
    for label in DB_LABELS:
        argv += ["--sketch-db", os.path.join(out_dir, f"{label}.msh")]
    runs = {}
    for cmd in ("run", "legacy"):
        out = os.path.join(tmp, f"cli_{cmd}")
        torch.cuda.synchronize()
        zero_launches()
        t = time.perf_counter()
        rc = cli.main([cmd, *argv, "--out", out])
        torch.cuda.synchronize()
        runs[cmd] = {"s": time.perf_counter() - t, "launches": all_launches()}
        if rc != 0:
            raise AssertionError(f"{cmd} on the .msh DBs exited {rc}")
        with open(os.path.join(out, "metadata.json")) as f:
            if json.load(f)["first_hit_fallback"]:
                raise AssertionError(f"{cmd}: the first-hit fallback ran")
    missing = [k for k, n in runs["run"]["launches"].items() if n <= 0 and k not in RUN_IDLE]
    if missing:
        raise AssertionError(f"kernels not launched by the .msh run: {missing}")
    for name in ("classified_sequences.tsv", "hymet.contigs.cami.tsv"):
        if not filecmp.cmp(os.path.join(tmp, "cli_run", name), os.path.join(cfg8.outdir, name),
                           shallow=False):
            raise AssertionError(f"{name} of the .msh CLI run differs from phase 8's")
    legacy = os.path.join(tmp, "cli_legacy")
    (key,) = os.listdir(cfg8.cache_root)
    again = os.path.join(tmp, "legacy_again.tsv")
    classified, total = classify_paf_legacy(
        os.path.join(legacy, "work", "resultados.paf"),
        os.path.join(cfg8.cache_root, key, "detailed_taxonomy.tsv"),
        os.path.join(WORLD, "taxonomy", "taxonomy_hierarchy.tsv"), again)
    if not filecmp.cmp(os.path.join(legacy, "classified_sequences.tsv"), again, shallow=False):
        raise AssertionError("the legacy run's TSV is not the legacy classifier's")
    emit("db", t0, genomes=sum(len(f) for f in files.values()),
         bases=int(sum(committed[label].lengths.sum() for label in DB_LABELS)),
         identical_to_committed=True, cli_sketch_s=cli_s, launches=launches,
         pieces_launches=pieces, build_split=split,
         batches=[["db", "rows", "L", "valid_windows"], *shapes], kernels=stats,
         earlier_route_ms=earlier_route_ms,
         msh_run={"s": runs["run"]["s"], "launches": runs["run"]["launches"],
                  "identical_to_phase_8": True},
         legacy_run={"s": runs["legacy"]["s"], "classified": classified, "queries": total})
    # bottom_sketch's launches are the build in pieces' (its only path)
    return {"launches": {**launches, "bottom_sketch": pieces["bottom_sketch"]}, **stats}


COMPLEMENT = bytes.maketrans(b"ACGTacgtN", b"TGCAtgcaN")


def second_assembly(names, seqs, taxids: dict, fasta: str, table: str) -> list:
    """The contigs as another assembly of the same sample would give them:
    renamed asm2_<i>, odd ones reverse-complemented, even ones cut by
    max(1, len // 200) bases at each end; written to `fasta`, with a truth
    table `table` that gives each new name its source contig's taxid in
    `taxids`. Returns the new names."""
    new = [f"asm2_{i}" for i in range(len(seqs))]
    with open(fasta, "w") as f:
        for i, (name, seq) in enumerate(zip(new, seqs)):
            if i % 2:
                seq = seq.translate(COMPLEMENT)[::-1]
            else:
                cut = max(1, len(seq) // 200)
                seq = seq[cut:-cut]
            f.write(f">{name}\n{seq.decode()}\n")
    with open(table, "w") as f:
        f.write("contig_id\ttaxid\n")
        f.writelines(f"{m}\t{taxids[n]}\n" for m, n in zip(new, names))
    return new


def timed(log: dict, key: str, fn):
    """fn, adding its seconds (between two synchronizes) to log[key] and
    its result to log[key + "_out"]."""
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        log[key] = log.get(key, 0.0) + time.perf_counter() - t
        log[key + "_out"] = out
        return out
    return run


def read_rows(path: str) -> list:
    with open(path, newline="") as f:
        return [ln.rstrip("\r\n").split("\t") for ln in f][1:]


def eval_cli(argv: list, out: str, log: dict) -> dict:
    """cli.main(["eval", *argv]) with the remap, its index build and its
    map timed into `log`; its launches, counted from 0."""
    torch.cuda.synchronize()
    zero_launches()
    with mock.patch.object(eval_cami, "_contig_remap",
                           timed(log, "remap_s", eval_cami._contig_remap)), \
         mock.patch.object(MinimizerIndex, "build_from_fasta",
                           staticmethod(timed(log, "index_s", MinimizerIndex.build_from_fasta))), \
         mock.patch.object(MinimizerAligner, "map_batch",
                           timed(log, "map_s", MinimizerAligner.map_batch)):
        t = time.perf_counter()
        rc = cli.main(["eval", *argv, "--out", out])
        torch.cuda.synchronize()
        log["eval_s"] = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"eval into {out} exited {rc}")
    return align_launches()


def unpaired(records, counterpart: dict, pairs: dict, min_cov: float = 0.95,
             min_id: float = 0.95) -> dict:
    """Why the remap left contigs unpaired: each one's best record (by
    nmatch) on its own counterpart failed the identity bound (nmatch /
    blocklen, ROADMAP C8), the coverage bound, or there was none; with the
    range of the identity failures' coverage and identity."""
    best = {}
    for r in records:
        if r.qname not in pairs and r.tname == counterpart[r.qname]:
            if r.qname not in best or r.nmatch > best[r.qname].nmatch:
                best[r.qname] = r
    cov = {q: (r.qend - r.qstart) / r.qlen for q, r in best.items()}
    ident = {q: r.nmatch / r.blocklen for q, r in best.items()}
    by_id = [q for q in best if cov[q] >= min_cov and ident[q] < min_id]
    return {"identity": len(by_id), "coverage": sum(1 for q in best if cov[q] < min_cov),
            "no_record": len(counterpart) - len(pairs) - len(best),
            "identity_fail_cov": [min(map(cov.get, by_id), default=None),
                                  max(map(cov.get, by_id), default=None)],
            "identity_fail_id": [min(map(ident.get, by_id), default=None),
                                 max(map(ident.get, by_id), default=None)]}


def phase_eval(tmp: str, seed: int) -> None:
    """Phase 11: eval on phase 8's run, by name and by a remap against a
    second assembly; then testdataset and subset."""
    t0 = time.perf_counter()
    os.environ["HYMET_PLATFORM"] = "cuda"
    cfg8 = run_config(tmp)
    (key,) = os.listdir(cfg8.cache_root)
    run_files = ["--pred-profile", os.path.join(cfg8.outdir, "hymet.contigs.cami.tsv"),
                 "--truth-profile", os.path.join(GUT, "truth_profile.tsv"),
                 "--pred-contigs", os.path.join(cfg8.outdir, "classified_sequences.tsv"),
                 "--pred-fasta", CONTIGS, "--taxonomy-dir", os.path.join(WORLD, "taxonomy"),
                 "--taxmap", os.path.join(cfg8.cache_root, key, "detailed_taxonomy.tsv"),
                 "--paf", os.path.join(cfg8.outdir, "work", "resultados.paf")]
    # by name, as the harness scores a run
    by_name = os.path.join(tmp, "eval_name")
    log = {}
    launches = eval_cli([*run_files, "--truth-contigs", os.path.join(GUT, "truth_contigs.tsv")],
                        by_name, log)
    if any(launches.values()) or "remap_s" in log:
        raise AssertionError(f"eval by name ran the remap: {launches}")
    summary = read_rows(os.path.join(by_name, "profile_summary.tsv"))
    per_rank = read_rows(os.path.join(by_name, "contigs_per_rank.tsv"))
    # by remap, against a second assembly
    names, seqs = read_fasta(CONTIGS)
    taxids = dict(read_rows(os.path.join(GUT, "truth_contigs.tsv")))
    asm2, table = os.path.join(tmp, "asm2.fna"), os.path.join(tmp, "asm2_truth.tsv")
    new = second_assembly(names, seqs, taxids, asm2, table)
    argv = [*run_files, "--truth-contigs", table, "--truth-fasta", asm2]
    remap = {}
    launches = eval_cli(argv, os.path.join(tmp, "eval_remap"), remap)
    index = remap["index_s_out"]
    k_w = index.k + index.w
    groups = len(plan_query_groups([len(q) for q in seqs], AlignerConfig().batch_pad, k_w)[0])
    index_calls = len(_row_batches([int(n) for n in index.lengths], k_w - 1))
    want = {"minimizers": groups + index_calls, "anchors": groups, "chains": groups}
    if any(launches[k] < n for k, n in want.items()):
        raise AssertionError(f"the remap's launches {launches} are below {want}")
    pairs = remap["remap_s_out"]
    counterpart = dict(zip(names, new))
    wrong = {q: t for q, t in pairs.items() if counterpart[q] != t}
    if wrong or not pairs:
        raise AssertionError(f"{len(wrong)} of {len(pairs)} remap pairs are not counterparts")
    plain = {}
    with plain_ops():
        eval_cli(argv, os.path.join(tmp, "eval_plain"), plain)
    if plain["remap_s_out"] != pairs:
        raise AssertionError("the plain remap pairs other contigs")
    same_files(os.path.join(tmp, "eval_remap"), os.path.join(tmp, "eval_plain"),
               ["contigs_exact.tsv", "contigs_per_rank.tsv"])
    exact = read_rows(os.path.join(tmp, "eval_remap", "contigs_exact.tsv"))
    # the dataset tools (host code)
    t = time.perf_counter()
    dataset = os.path.join(tmp, "testdataset")
    if cli.main(["testdataset", GENOMES, "--out", dataset, "--seed", str(seed)]) != 0:
        raise AssertionError("testdataset failed")
    testdataset_s = time.perf_counter() - t
    with open(os.path.join(dataset, "gcf2seqid.tsv")) as f:
        genomes = sum(1 for _ in f) - 1
    subset = os.path.join(tmp, "subset.fna")
    t = time.perf_counter()
    if cli.main(["subset", CONTIGS, "--output", subset, "--max-seqs", "500",
                 "--max-bases", "5000000"]) != 0:
        raise AssertionError("subset failed")
    subset_s = time.perf_counter() - t
    subset_seqs = read_fasta(subset)[1]
    emit("eval", t0, by_name={"s": log["eval_s"], "profile_summary": summary,
                              "contigs_per_rank": per_rank},
         remap={"contigs": len(names), "bases": sum(map(len, seqs)), "pairs": len(pairs),
                "all_counterparts": True, "eval_s": remap["eval_s"], "remap_s": remap["remap_s"],
                "index_s": remap["index_s"], "map_s": remap["map_s"],
                "rest_s": remap["remap_s"] - remap["index_s"] - remap["map_s"],
                "unpaired": unpaired(remap["map_s_out"], counterpart, pairs),
                "launches": launches, "map_groups": groups, "index_batches": index_calls,
                "contigs_exact": exact, "identical_to_plain": True,
                "plain": {"remap_s": plain["remap_s"], "index_s": plain["index_s"],
                          "map_s": plain["map_s"]}},
         testdataset={"genomes": genomes, "s": testdataset_s},
         subset={"sequences": len(subset_seqs), "bases": sum(map(len, subset_seqs)),
                 "s": subset_s})


HARNESS_SAMPLES = ("camisyn_gut", "camisyn_marine", "camisyn_strainmadness")
HARNESS_KERNELS = ("screen_count", "minimizers", "anchors", "chains", "lca")


def counted_runs(log: list):
    """Context in which every ClassificationRun.execute counts its launches
    from 0 and appends its outdir, launches, seconds and fallback to `log`
    (the harnesses build their runs inside their own functions)."""
    real = ClassificationRun.execute

    def execute(self):
        torch.cuda.synchronize()
        zero_launches()
        t = time.perf_counter()
        out = real(self)
        torch.cuda.synchronize()
        log.append({"outdir": self.cfg.outdir, "s": time.perf_counter() - t,
                    "launches": all_launches(), "fallback_ran": self.fallback_ran})
        return out
    return mock.patch.object(ClassificationRun, "execute", execute)


def same_as_cpu_classification(outdir: str, cache_dir: str, scratch: str) -> None:
    """A run's classified_sequences.tsv against classify_paf of its own PAF
    on the CPU, with its reference's detailed_taxonomy.tsv."""
    cpu = os.path.join(scratch, "classified_cpu.tsv")
    classify_paf(os.path.join(outdir, "work", "resultados.paf"),
                 os.path.join(cache_dir, "detailed_taxonomy.tsv"),
                 os.path.join(WORLD, "taxonomy", "taxonomy_hierarchy.tsv"), cpu, device="cpu")
    if not filecmp.cmp(os.path.join(outdir, "classified_sequences.tsv"), cpu, shallow=False):
        raise AssertionError(f"{outdir}: the TSV differs from the CPU re-classification")


def checked_runs(runs: list, want: int, kernels, idle=()) -> list:
    """The runs' launches: `want` runs, each launching every kernel of
    `kernels` and none of `idle`, none falling back to first-hit."""
    if len(runs) != want:
        raise AssertionError(f"{len(runs)} runs finished, {want} expected")
    for r in runs:
        missing = [k for k in kernels if r["launches"][k] <= 0]
        if missing or any(r["launches"][k] for k in idle) or r["fallback_ran"]:
            raise AssertionError(f"{r['outdir']}: launches {r['launches']}, fallback "
                                 f"{r['fallback_ran']}")
    return [{k: r["launches"][k] for k in (*kernels, *idle)} for r in runs]


def ablation_seqmap(combined: str, path: str) -> None:
    """seqid -> taxid for the combined reference's headers, with each
    genome's accession too (acc2taxid.tsv), as the harness tests make it."""
    with open(os.path.join(WORLD, "acc2taxid.tsv")) as f:
        acc2tax = dict(ln.rstrip("\n").split("\t")[:2] for ln in f if ln.strip())
    with open(combined) as f, open(path, "w") as out:
        for line in f:
            if line.startswith(">"):
                name = line[1:].split()[0]
                acc = "_".join(name.split("_")[:2])
                out.write(f"{name}\t{acc2tax[acc]}\n{acc}\t{acc2tax[acc]}\n")


def phase_harness(tmp: str) -> None:
    """Phase 12: bench on the three in-repo CAMI samples, run at the bench's
    settings, case, ablation at two levels, truth build-zymo and fetch."""
    t0 = time.perf_counter()
    root = os.path.join(tmp, "harness")
    os.makedirs(root)
    cache = os.path.join(root, "cache")
    taxonomy = os.path.join(WORLD, "taxonomy")
    dbs = [os.path.join(WORLD, f"{label}.npz") for label in DB_LABELS]
    env = {"HYMET_PLATFORM": "cuda", "CACHE_ROOT": cache, "SKETCH_DBS": os.pathsep.join(dbs),
           "GENOME_CATALOG": GENOMES, "SEQID2TAXID": os.path.join(WORLD, "acc2taxid.tsv"),
           "TAXONOMY_DIR": taxonomy, "INPUT_FASTA": CONTIGS}
    steps, pairs = {}, []

    def cli_step(name: str, argv: list, want_rc: int = 0) -> None:
        torch.cuda.synchronize()
        t = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t
        if rc != want_rc:
            raise AssertionError(f"{argv[0]} exited {rc}")

    with mock.patch.dict(os.environ, env):
        for name in ("TAXONKIT_DB", "CAND_MAX", "SPECIES_DEDUP", "HYMET_PROFILE_WEIGHT"):
            os.environ.pop(name, None)
        # 1. bench
        data = {s: os.path.join(WORLD, "data", s) for s in HARNESS_SAMPLES}
        manifest = os.path.join(root, "manifest.tsv")
        with open(manifest, "w") as f:
            f.write("sample_id\tcontigs_fa\ttruth_contigs_tsv\ttruth_profile_tsv\n")
            for s, d in data.items():
                f.write(f"{s}\t{d}/contigs.fna\t{d}/truth_contigs.tsv\t{d}/truth_profile.tsv\n")
        bench_out = os.path.join(root, "bench")
        runs = []
        with counted_runs(runs):
            cli_step("bench", ["bench", "--manifest", manifest, "--tools", "hymet_tpu",
                               "--out", bench_out])
        launches = dict(zip(HARNESS_SAMPLES, checked_runs(runs, 3, HARNESS_KERNELS)))
        samples = {}
        for s, r in zip(HARNESS_SAMPLES, runs):
            tool_dir = os.path.join(bench_out, s, "hymet_tpu")
            work_out = os.path.join(tool_dir, "work_out")
            if r["outdir"] != work_out:
                raise AssertionError(f"run {r['outdir']} is not {s}'s")
            for name in ("profile.cami.tsv", "classified_sequences.tsv", "resultados.paf",
                         "metadata.json", "eval/profile_summary.tsv", "eval/contigs_per_rank.tsv"):
                if not os.path.getsize(os.path.join(tool_dir, name)):
                    raise AssertionError(f"{s}: {name} is empty")
            with open(os.path.join(work_out, "metadata.json")) as f:
                meta = json.load(f)
            if torch.device(meta["device"]).type != "cuda" or meta["first_hit_fallback"]:
                raise AssertionError(f"{s}: metadata {meta['device']}, {meta['first_hit_fallback']}")
            with open(os.path.join(work_out, "work", "selected_genomes.txt"), "rb") as f:
                key = hashlib.sha1(f.read()).hexdigest()
            same_as_cpu_classification(work_out, os.path.join(cache, key), root)
            pairs.append(f"{s}: TSV = CPU classify_paf of its PAF")
            samples[s] = {"run_s": r["s"], "stage_s": meta["timings_sec"], "cache_key": key,
                          "classified_rows": len(read_rows(os.path.join(tool_dir,
                                                                        "classified_sequences.tsv"))),
                          "profile_summary_species": [row for row in read_rows(os.path.join(
                              tool_dir, "eval", "profile_summary.tsv")) if row[0] == "species"]}
        stages = [row[:3] for row in read_rows(os.path.join(bench_out, "runtime_memory.tsv"))]
        if stages != [[s, "hymet_tpu", st] for s in HARNESS_SAMPLES for st in ("run", "eval")]:
            raise AssertionError(f"runtime_memory.tsv rows {stages}")
        for name in ("summary_per_tool_per_sample.tsv", "contig_accuracy_per_tool.tsv"):
            got = {row[0] for row in read_rows(os.path.join(bench_out, name))}
            if got != set(HARNESS_SAMPLES):
                raise AssertionError(f"{name} holds samples {got}")
        if {row[2] for row in read_rows(os.path.join(bench_out, "leaderboard_by_rank.tsv"))} != {"3"}:
            raise AssertionError("the leaderboard does not average 3 samples")
        gut = os.path.join(bench_out, "camisyn_gut", "hymet_tpu")
        gut_paf = os.path.join(gut, "resultados.paf")
        cpu_eval = os.path.join(root, "gut_eval_cpu")
        eval_cami.evaluate(pred_profile=os.path.join(gut, "profile.cami.tsv"),
                           truth_profile=os.path.join(GUT, "truth_profile.tsv"),
                           pred_contigs=os.path.join(gut, "classified_sequences.tsv"),
                           truth_contigs=os.path.join(GUT, "truth_contigs.tsv"), pred_fasta=CONTIGS,
                           truth_fasta=None, taxonomy_dir=taxonomy, paf=gut_paf, outdir=cpu_eval,
                           device="cpu")
        if sorted(os.listdir(os.path.join(gut, "eval"))) != sorted(os.listdir(cpu_eval)):
            raise AssertionError("gut's eval/ and the CPU evaluation wrote other files")
        same_files(os.path.join(gut, "eval"), cpu_eval, os.listdir(cpu_eval))
        pairs.append(f"gut eval/ ({len(os.listdir(cpu_eval))} files) = evaluate on the CPU")
        # run on gut at the bench's settings, on its cache: the bench's bytes
        run_out = os.path.join(root, "run_gut")
        rerun = []
        with counted_runs(rerun):
            cli_step("run_gut", ["run", "--contigs", CONTIGS, "--out", run_out, "--cand-max",
                                 "1500", "--species-dedup", "--cache-root", cache,
                                 "--taxonomy-dir", taxonomy, *(a for db in dbs
                                                               for a in ("--sketch-db", db)),
                                 "--genome-catalog", GENOMES, "--seqid2taxid",
                                 os.path.join(WORLD, "acc2taxid.tsv")])
        checked_runs(rerun, 1, HARNESS_KERNELS)
        for name in ("classified_sequences.tsv", "work/resultados.paf", "hymet.contigs.cami.tsv"):
            if not filecmp.cmp(os.path.join(run_out, name),
                               os.path.join(gut, "work_out", name), shallow=False):
                raise AssertionError(f"run's {name} differs from the bench's gut run")
        pairs.append("run --cand-max 1500 --species-dedup on gut = bench's gut TSV, PAF, profile")
        # 2. case
        case_manifest = os.path.join(root, "case_manifest.tsv")
        with open(case_manifest, "w") as f:
            f.write("sample_id\tcontigs_fa\ttruth_contigs_tsv\ttruth_profile_tsv\t"
                    "compare_profile\n")
            f.write(f"camisyn_gut\t{CONTIGS}\t{GUT}/truth_contigs.tsv\t{GUT}/truth_profile.tsv\t"
                    f"{gut}/profile.cami.tsv\n")
        case_out = os.path.join(root, "case")
        case_runs = []
        with counted_runs(case_runs):
            cli_step("case", ["case", "--manifest", case_manifest, "--out", case_out])
        checked_runs(case_runs, 1, HARNESS_KERNELS)
        case_dir = os.path.join(case_out, "camisyn_gut", "hymet_tpu")
        with open(os.path.join(case_dir, "profile_compare.tsv")) as f:
            compare = f.read()
        if compare != ("metric\tvalue\nsymmetric_kl_species\t0.000000\n"
                       "spearman_species\t1.000000\n"):
            raise AssertionError(f"profile_compare.tsv reads {compare!r}")
        if not os.path.getsize(os.path.join(case_dir, "top_taxa.tsv")):
            raise AssertionError("top_taxa.tsv is empty")
        pairs.append("case profile vs bench gut profile: KL 0, Spearman 1")
        # 3. ablation of the bench's cached gut reference
        key = samples["camisyn_gut"]["cache_key"]
        combined = os.path.join(cache, key, "combined_genomes.fasta")
        seqmap = os.path.join(root, "seqmap.tsv")
        ablation_seqmap(combined, seqmap)
        counts = {}
        for _contig, taxid in read_rows(os.path.join(GUT, "truth_contigs.tsv")):
            counts[taxid] = counts.get(taxid, 0) + 1
        taxa = sorted(counts, key=lambda t: (-counts[t], t))[:3]
        ab_out = os.path.join(root, "ablation")
        ab_runs = []
        with counted_runs(ab_runs):
            cli_step("ablation", ["ablation", "--sample", "camisyn_gut", "--taxa", ",".join(taxa),
                                  "--levels", "0.0,1.0", "--seqmap", seqmap, "--fasta", combined,
                                  "--out", ab_out])
        ab_launches = checked_runs(ab_runs, 2, HARNESS_KERNELS[1:], idle=("screen_count",))
        fallback = read_rows(os.path.join(ab_out, "rank_fallback.tsv"))
        if len(fallback) != 2 or int(fallback[0][1]) <= 0:
            raise AssertionError(f"rank_fallback.tsv reads {fallback}")
        levels = {}
        for label, r, row in zip(("000", "100"), ab_runs, fallback):
            lvl = os.path.join(ab_out, f"level_{label}")
            (lvl_key,) = os.listdir(os.path.join(ab_out, "cache", label))
            same_as_cpu_classification(lvl, os.path.join(ab_out, "cache", label, lvl_key), root)
            pairs.append(f"ablation level {label}: TSV = CPU classify_paf of its PAF")
            levels[label] = {"run_s": r["s"], "rank_fallback": row}
        summary = read_rows(os.path.join(ab_out, "refsets", "ablation_summary.tsv"))
        level_rows = [dict((r[0], r[1:]) for r in read_rows(os.path.join(ab_out, f"level_{label}",
                                                                          "classified_sequences.tsv")))
                      for label in ("000", "100")]
        moved = sum(1 for q, r in level_rows[0].items() if level_rows[1].get(q) != r)
        # 4. truth build-zymo on the bench's gut PAF (host code)
        zymo = {name: os.path.join(root, f"zymo_{name}.tsv") for name in ("c", "p")}
        cli_step("build_zymo", ["truth", "build-zymo", "--contigs", CONTIGS, "--paf", gut_paf,
                                "--seqmap", seqmap, "--out-contigs", zymo["c"],
                                "--out-profile", zymo["p"]])
        with mock.patch.dict(os.environ, {"HYMET_PLATFORM": "cpu"}):
            assigned = zymo_truth.build_zymo_truth(
                CONTIGS, gut_paf, os.path.join(root, "zymo_c_cpu.tsv"),
                os.path.join(root, "zymo_p_cpu.tsv"), seqmap=seqmap, taxonomy_dir=taxonomy)
        for name in ("c", "p"):
            if not filecmp.cmp(zymo[name], os.path.join(root, f"zymo_{name}_cpu.tsv"),
                               shallow=False):
                raise AssertionError(f"truth build-zymo's {name} file differs from the CPU's")
        pairs.append("truth build-zymo = build_zymo_truth under HYMET_PLATFORM=cpu")
        # 5. fetch of file:// URLs
        fetch_manifest = os.path.join(root, "fetch", "manifest.tsv")
        os.makedirs(os.path.dirname(fetch_manifest))
        sources = {c: os.path.join(GUT, n) for c, n in (
            ("contigs", "contigs.fna"), ("truth_contigs", "truth_contigs.tsv"),
            ("truth_profile", "truth_profile.tsv"))}
        with open(fetch_manifest, "w") as f:
            f.write("sample_id\tcontigs_fa\ttruth_contigs_tsv\ttruth_profile_tsv\tcontigs_url\t"
                    "truth_contigs_url\ttruth_profile_url\n")
            f.write("camisyn_gut\tgut/contigs.fna\tgut/truth_contigs.tsv\tgut/truth_profile.tsv\t"
                    + "\t".join("file://" + os.path.abspath(p) for p in sources.values()) + "\n")
        cli_step("fetch", ["fetch", "--manifest", fetch_manifest])
        for c, src in sources.items():
            got = os.path.join(root, "fetch", "gut", os.path.basename(src))
            if not filecmp.cmp(got, src, shallow=False):
                raise AssertionError(f"fetch's {c} differs from its source")
        pairs.append("fetch: 3 file:// assets = their sources")
    emit("harness", t0, steps_s=steps, samples=samples, launches=launches,
         run_gut_launches=rerun[0]["launches"], case_launches=case_runs[0]["launches"],
         ablation={"taxa": taxa, "reference_genomes": sum(1 for ln in open(combined)
                                                         if ln.startswith(">")),
                   "levels": levels, "launches": ab_launches, "summary": summary,
                   "rows_changed_at_100": moved},
         zymo={"assigned": len(assigned),
               "species": sum(1 for v in assigned.values() if v[1] == "species")},
         pairs=pairs, nvidia_smi=nvidia_smi("name,power.limit"))


SHARDED_MESH = (2, 4)  # ("data", "db") of phase 13: db_shards = 4 over 8 devices
SHARDED_KERNELS = ("screen_count", "minimizers", "anchors", "chains")


def per_shard_launches(log: dict):
    """Context in which each shard's launches are counted apart: the launch
    counts that ScreenEngine.update_staged (a shard's screen_count) and
    MinimizerAligner._dispatch_fused (a shard's minimizers, anchors and
    chains) add are summed in log[(stage, the shard's first reference)]."""
    real_update, real_dispatch = ScreenEngine.update_staged, MinimizerAligner._dispatch_fused

    def update_staged(self, *args):
        before = hash_kernels.screen_count.launches
        real_update(self, *args)
        log.setdefault(("screen", self.db.names[0]), Counter())["screen_count"] += (
            hash_kernels.screen_count.launches - before)

    def dispatch(self, *args):
        before = align_launches()
        out = real_dispatch(self, *args)
        shard = log.setdefault(("align", self.index.names[0]), Counter())
        for name, n in align_launches().items():
            shard[name] += n - before[name]
        return out

    stack = ExitStack()
    stack.enter_context(mock.patch.object(ScreenEngine, "update_staged", update_staged))
    stack.enter_context(mock.patch.object(MinimizerAligner, "_dispatch_fused", dispatch))
    return stack


def same_screen(got, want, what: str) -> None:
    """Identity (float32 bits), shared, median and the window total."""
    ident = np.asarray(want.identity, dtype=np.float32)
    if not (np.array_equal(np.asarray(got.identity, dtype=np.float32).view(np.uint32),
                           ident.view(np.uint32))
            and np.array_equal(got.shared, want.shared) and np.array_equal(got.median, want.median)
            and got.total_query_kmers == want.total_query_kmers):
        raise AssertionError(f"{what}: the sharded screen differs")


def classified_rows(path: str) -> dict:
    with open(path, newline="") as f:
        rows = f.read().split("\r\n")[1:-1]
    return {r.split("\t", 1)[0]: r for r in rows}


def phase_sharded(tmp: str, seed: int, cfg: RunConfig) -> dict:
    """Phase 13: the reference sharded over a 2x4 mesh of the card named
    eight times. (a) sharded_topk on the card against the CPU; (b) the
    sharded screen of the gut contigs against merged sketch1-3 against the
    single-device engine and the plain count; (c) execute at db_shards = 4
    against phase 8's selection and a re-run of its align stage with the
    plain versions; (d) each shard's launches; (e) the rows that differ
    from phase 8's run."""
    t0 = time.perf_counter()
    card = [torch.device("cuda", 0)] * 8
    mesh = make_mesh(*SHARDED_MESH, devices=card)
    cpu_mesh = make_mesh(*SHARDED_MESH, devices=["cpu"] * 8)
    # (a) ties on purpose: 50 distinct values over 65,536 scores
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 50, 1 << 16).astype(np.float32)
    for k in (1, 100, 5000, 1 << 16):
        got = sharded_topk(mesh, torch.from_numpy(scores).cuda(), k)
        want = sharded_topk(cpu_mesh, torch.from_numpy(scores), k)
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise AssertionError(f"sharded_topk on the card differs from the CPU at k={k}")

    # (b) the chunked sharded screen, counted, against the single-device
    # engine on the staged batches with the kernel and with the plain count
    merged = SketchDB.concat(load_world_dbs())
    batches = []
    real_update = ShardedScreenEngine.update_codes_packed  # what stream_screen calls
    torch.cuda.synchronize()
    zero_launches()
    t = time.perf_counter()
    with mock.patch.object(ShardedScreenEngine, "update_codes_packed",
                           lambda self, codes: batches.append(1) or real_update(self, codes)):
        sharded = stream_screen(merged, [CONTIGS], chunk_bp=cfg.screen_chunk_bp, mesh=mesh)
    torch.cuda.synchronize()
    screen_s = time.perf_counter() - t
    screen_launches = hash_kernels.screen_count.launches
    staged = stage_contigs(cfg)
    single = stream_screen(merged, [CONTIGS], staged=staged, device="cuda")
    with counting_with(screen_count_torch):
        plain = stream_screen(merged, [CONTIGS], staged=staged, device="cuda")
    same_screen(sharded, single, "against the single-device engine")
    same_screen(sharded, plain, "against the plain count")
    if screen_launches != SHARDED_MESH[1] * len(batches):
        raise AssertionError(f"{screen_launches} screen_count launches for {len(batches)} "
                             f"batches and {SHARDED_MESH[1]} shards")

    # (c) the whole run at db_shards = 4 with a cold cache
    run_cfg = run_config(tmp)
    run_cfg.outdir, run_cfg.cache_root = os.path.join(tmp, "sharded"), os.path.join(tmp, "sharded_cache")
    run_cfg.db_shards = SHARDED_MESH[1]
    shard_log: dict = {}
    torch.cuda.synchronize()
    zero_launches()
    t = time.perf_counter()
    with per_shard_launches(shard_log):
        run = ClassificationRun(run_cfg, device="cuda", mesh_devices=card)
        classified = run.execute()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = all_launches()
    if run.mesh is None or run.mesh.shape != {"data": 2, "db": 4} or run.fallback_ran:
        raise AssertionError(f"sharded run: mesh {run.mesh}, fallback {run.fallback_ran}")
    single_run = run_config(tmp).outdir  # phase 8's
    work = os.path.join(run_cfg.outdir, "work")
    same_files(work, os.path.join(single_run, "work"), ["selected_genomes.txt"])
    (key,) = os.listdir(run_cfg.cache_root)
    cache = os.path.join(run_cfg.cache_root, key)
    index = MinimizerIndex.load(os.path.join(cache, f"reference_minidx_k{run_cfg.align_k}"
                                                    f"w{run_cfg.align_w}.npz"))
    names, seqs = read_fasta(CONTIGS)
    zero_launches()
    t = time.perf_counter()
    plain_aligner = ShardedMinimizerAligner(mesh, index, AlignerConfig(batch_pad=run_cfg.align_batch_pad),
                                            ops=align_kernels.PLAIN)
    plain_dir = os.path.join(tmp, "sharded_plain")
    os.makedirs(plain_dir)
    write_paf(os.path.join(plain_dir, "resultados.paf"), plain_aligner.map_batch(names, seqs))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    if any(align_launches().values()):
        raise AssertionError(f"the plain re-run launched a kernel: {align_launches()}")
    same_files(work, plain_dir, ["resultados.paf"])
    plain_tsv = os.path.join(plain_dir, "classified_sequences.tsv")
    classify_paf(os.path.join(plain_dir, "resultados.paf"), os.path.join(cache, "detailed_taxonomy.tsv"),
                 run._hierarchy_path(), plain_tsv, device="cpu")
    if not filecmp.cmp(classified, plain_tsv, shallow=False):
        raise AssertionError("the sharded run's TSV differs from the plain re-run's")

    # (d) every shard through every kernel of the path
    screen_shards = [s.names[0] for s in merged.shard(SHARDED_MESH[1]) if s.n_refs]
    align_shards = [s.names[0] for s in index.shard(SHARDED_MESH[1]) if s.n_minimizers]
    n_groups = -(-len(seqs) // 64)
    per_shard = {f"{stage}:{name}": dict(c) for (stage, name), c in shard_log.items()}
    short = [n for n in screen_shards if shard_log.get(("screen", n), {}).get("screen_count", 0) <= 0]
    short += [n for n in align_shards for kn in ("minimizers", "anchors", "chains")
              if shard_log.get(("align", n), {}).get(kn, 0) < n_groups]
    missing = [kn for kn in (*SHARDED_KERNELS, "lca") if launches[kn] <= 0]
    if short or missing or len(screen_shards) != SHARDED_MESH[1] or len(align_shards) != SHARDED_MESH[1]:
        raise AssertionError(f"shards {short} or kernels {missing} not launched: {per_shard}")

    # the sharded map's wall and device time beside the one-device map of
    # the same contigs, unstaged, on the same index (3 timed runs, 1 traced)
    aln_cfg = AlignerConfig(batch_pad=run_cfg.align_batch_pad)
    maps = {}
    for tag, aligner in (("sharded", ShardedMinimizerAligner(mesh, index, aln_cfg)),
                         ("one_device", MinimizerAligner(index, aln_cfg, device="cuda"))):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            aligner.map_batch(names, seqs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        prof = profile_run(lambda: aligner.map_batch(names, seqs),
                           counted=((align_kernels.minimizers, "minimizer_tile_kernel"),
                                    (align_kernels.anchors, "anchor_search_kernel")), lost=ANY_LOST)
        maps[tag] = {"s": times, "profiled_wall_s": prof["wall_s"],
                     "device_busy_s": prof["device_busy_s"], "idle_share": prof["idle_share"],
                     "launches": prof["launches"], "top_device_ms": prof["device_ms"][:6]}

    # (e) a fact, not a gate: max_occ applies to each shard's index
    mine = classified_rows(classified)
    theirs = classified_rows(os.path.join(single_run, "classified_sequences.tsv"))
    differ = sum(1 for q in set(mine) | set(theirs) if mine.get(q) != theirs.get(q))
    with open(os.path.join(work, "resultados.paf")) as f:
        n_records = sum(1 for _ in f)
    emit("sharded", t0, mesh=SHARDED_MESH, topk_identical=True,
         screen={"s": screen_s, "batches": len(batches), "screen_count": screen_launches,
                 "identical_to_single_and_plain": True,
                 "total_query_kmers": sharded.total_query_kmers},
         execute_s=run_s, stage_s=run.timings, launches=launches, per_shard=per_shard,
         groups=n_groups, paf_records=n_records, plain_align_s=plain_s, map_batch=maps,
         paf_and_tsv_identical_to_plain=True, selected_identical_to_phase_8=True,
         classified_rows=len(mine), rows_differing_from_phase_8=differ,
         nvidia_smi=nvidia_smi("name,power.limit"))
    return launches


def native_check() -> dict:
    """The native host helpers (the CPU path's: io/native_io.py) built with
    this machine's host compiler and held against the numpy versions on
    the gut contigs: encode, hashes at k = 21, minimizers at k = 19, w = 19.
    Host code: equality and seconds only."""
    t = time.perf_counter()
    if not native_io.build() or not native_io.available():
        raise AssertionError(f"the native host helpers did not build into {native_io.library_path()}")
    out = {"library": os.path.relpath(native_io.library_path(), REPO),
           "build_s": time.perf_counter() - t}
    names, seqs = read_fasta(CONTIGS)
    codes = [encode_seq(s) for s in seqs]
    checks = (
        ("encode", native_io.encode_seq, encode_seq, seqs),
        ("kmer_hashes_k21", lambda c: native_io.kmer_hashes(c, 21),
         lambda c: kmer_hashes_numpy(c, 21), codes),
        ("minimizers_k19_w19", lambda c: native_io.minimizers(c, 19, 19),
         lambda c: extract_minimizers_numpy(c, 19, 19), codes),
    )
    for name, native, plain, inputs in checks:
        t = time.perf_counter()
        got = [native(x) for x in inputs]
        native_s = time.perf_counter() - t
        t = time.perf_counter()
        want = [plain(x) for x in inputs]
        plain_s = time.perf_counter() - t
        for g, w in zip(got, want):
            g, w = (g, w) if isinstance(g, tuple) else ((g,), (w,))
            if not all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(g, w)):
                raise AssertionError(f"native {name} differs from numpy's")
        out[name] = {"native_s": native_s, "numpy_s": plain_s, "identical": True}
    out["contigs"], out["bases"] = len(seqs), sum(map(len, seqs))
    return out


DIST_SHARDS = 4  # db_shards of phase 14: phase 13's run, over processes
DIST_FILES = ("work/selected_genomes.txt", "work/resultados.paf", "classified_sequences.tsv",
              "hymet.contigs.cami.tsv")
DIST_TIMEOUT_S = 600


def dist_world() -> int:
    """Processes of phase 14: one a card where 4 are visible, else 2 on
    the one card."""
    return DIST_SHARDS if torch.cuda.device_count() >= DIST_SHARDS else 2


def dist_config(root: str) -> RunConfig:
    cfg = run_config(root)
    cfg.db_shards = DIST_SHARDS
    return cfg


def dist_worker(rank: int, world: int, port: int, root: str) -> int:
    """One process of phase 14: joins the group on 127.0.0.1:`port`, names
    its card (``LOCAL_RANK``'s) DIST_SHARDS / world times for a global
    1 x DIST_SHARDS mesh, runs ``execute`` on the gut sample with a cold
    cache under `root`, every launch count set to 0 just before and read
    just after, and prints one JSON line: its seconds, stage split,
    launches (each shard's apart) and chunked screen batches."""
    init_distributed(f"127.0.0.1:{port}", num_processes=world, process_id=rank)
    card = local_card()
    torch.cuda.set_device(card)
    shard_log: dict = {}
    batches = []
    real_update = ShardedScreenEngine.update_codes_packed  # what stream_screen calls
    torch.cuda.synchronize(card)
    zero_launches()
    t = time.perf_counter()
    with per_shard_launches(shard_log), mock.patch.object(
            ShardedScreenEngine, "update_codes_packed",
            lambda self, codes: batches.append(1) or real_update(self, codes)):
        run = ClassificationRun(dist_config(root), device=card,
                                mesh_devices=[card] * (DIST_SHARDS // world))
        run.execute()
    torch.cuda.synchronize(card)
    report = json.dumps({
        "rank": rank, "device": str(card), "execute_s": time.perf_counter() - t,
        "stage_s": run.timings, "launches": all_launches(),
        "per_shard": {f"{stage}:{name}": dict(c) for (stage, name), c in shard_log.items()},
        "screen_batches": len(batches), "mesh": run.mesh.shape, "owners": run.mesh.owners,
        "local_shards": run.mesh.local_shards, "outdir": run.cfg.outdir,
        "cache_root": run.cfg.cache_root, "fallback_ran": run.fallback_ran})
    shutdown()
    print(report, flush=True)
    return 0


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_workers(world: int, root: str, logs: str) -> list:
    """Start phase 14's processes, wait for all of them (killing every one
    when one fails or DIST_TIMEOUT_S passes) and return each one's JSON
    line. Their output goes to files under `logs`."""
    port = free_port()
    os.makedirs(logs)
    procs, files = [], []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items()
               if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
        # one card a process where there are enough, else all on card 0
        env["LOCAL_RANK"] = str(rank if torch.cuda.device_count() >= world else 0)
        out = open(os.path.join(logs, f"rank{rank}.out"), "w")
        err = open(os.path.join(logs, f"rank{rank}.err"), "w")
        files += [out, err]
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(rank), str(world),
             str(port), root], cwd=REPO, env=env, stdout=out, stderr=err))
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
    reports = []
    for rank, p in enumerate(procs):
        with open(os.path.join(logs, f"rank{rank}.err")) as f:
            err = f.read()
        if p.returncode != 0:
            raise AssertionError(f"distributed worker {rank} exited {p.returncode}:\n{err[-4000:]}")
        with open(os.path.join(logs, f"rank{rank}.out")) as f:
            reports.append(json.loads(f.read().strip().splitlines()[-1]))
    return reports


def phase_distributed(tmp: str) -> list:
    """Phase 14: phase 13's run at db_shards = 4 over processes (2 on the
    one card, each naming it twice; one a card where 4 are visible), each
    process a ``torch.distributed`` gloo rank running ``execute`` on the
    gut sample with a cold cache. Process 0's files must equal phase 13's
    byte for byte, every other process's must equal them under its
    ``.proc<i>`` paths (and it writes nowhere else), each process must
    launch ``screen_count`` once a chunked batch on each of its own shards
    and on no other, ``minimizers``, ``anchors`` and ``chains`` at least
    once a group of 64 contigs on each of its index shards, and ``lca``."""
    t0 = time.perf_counter()
    world = dist_world()
    per_process = DIST_SHARDS // world
    root, logs = os.path.join(tmp, "distributed"), os.path.join(tmp, "distributed_logs")
    os.makedirs(root)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the workers share the card with this process
    reports = run_workers(world, root, logs)
    phase_s = time.perf_counter() - t0

    cfg = dist_config(root)
    suffixes = [""] + [f".proc{r}" for r in range(1, world)]
    want_entries = sorted(os.path.basename(p) + s for s in suffixes
                          for p in (cfg.outdir, cfg.cache_root))
    if sorted(os.listdir(root)) != want_entries:
        raise AssertionError(f"distributed run wrote {sorted(os.listdir(root))}, "
                             f"not {want_entries}")
    sharded = os.path.join(tmp, "sharded")  # phase 13's run at db_shards = 4
    (key,) = os.listdir(cfg.cache_root)
    index = MinimizerIndex.load(os.path.join(cfg.cache_root, key,
                                             f"reference_minidx_k{cfg.align_k}w{cfg.align_w}.npz"))
    screen_names = [s.names[0] if s.n_refs else None
                    for s in SketchDB.concat(load_world_dbs()).shard(DIST_SHARDS)]
    index_names = [s.names[0] if s.n_minimizers else None for s in index.shard(DIST_SHARDS)]
    n_groups = -(-len(read_fasta(CONTIGS)[0]) // 64)
    for rank, (rep, suffix) in enumerate(zip(reports, suffixes)):
        mine = list(range(rank * per_process, (rank + 1) * per_process))
        if (rep["rank"], rep["outdir"], rep["cache_root"], rep["mesh"], rep["local_shards"],
                rep["fallback_ran"]) != (rank, cfg.outdir + suffix, cfg.cache_root + suffix,
                                         {"data": 1, "db": DIST_SHARDS}, mine, False):
            raise AssertionError(f"distributed worker {rank}: {rep}")
        for name in DIST_FILES:
            want = os.path.join(sharded if rank == 0 else cfg.outdir, name)
            if not filecmp.cmp(os.path.join(rep["outdir"], name), want, shallow=False):
                raise AssertionError(f"distributed worker {rank}: {name} differs from {want}")
        screen = {n for n in (screen_names[i] for i in mine) if n}
        index_shards = {n for n in (index_names[i] for i in mine) if n}
        shards = rep["per_shard"]
        screen_ok = ({k.split(":", 1)[1] for k in shards if k.startswith("screen:")} == screen
                     and all(shards[f"screen:{n}"]["screen_count"] == rep["screen_batches"] > 0
                             for n in screen)
                     and rep["launches"]["screen_count"] == len(screen) * rep["screen_batches"])
        align_ok = ({k.split(":", 1)[1] for k in shards if k.startswith("align:")} == index_shards
                    and all(shards[f"align:{n}"].get(kn, 0) >= n_groups for n in index_shards
                            for kn in ("minimizers", "anchors", "chains")))
        if not (screen_ok and align_ok and rep["launches"]["lca"] > 0):
            raise AssertionError(f"distributed worker {rank}'s launches: {rep['launches']}, "
                                 f"{shards}, {rep['screen_batches']} batches")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    emit("distributed", t0, processes=world, cards=torch.cuda.device_count(),
         mesh=[1, DIST_SHARDS], workers_s=phase_s, groups=n_groups,
         files_identical_to_phase_13=True, per_process_outputs=want_entries,
         processes_report=[{k: rep[k] for k in ("rank", "device", "execute_s", "stage_s",
                                                 "launches", "per_shard", "screen_batches",
                                                 "local_shards")} for rep in reports],
         nvidia_smi=smi.strip().splitlines())
    return reports


def sharded_reference_run(tmp: str) -> None:
    """Phase 13's run at db_shards = 4 alone (the card named eight times),
    for ``--only distributed``: what phase 14 is compared with."""
    t0 = time.perf_counter()
    cfg = run_config(tmp)
    cfg.outdir, cfg.cache_root = os.path.join(tmp, "sharded"), os.path.join(tmp, "sharded_cache")
    cfg.db_shards = DIST_SHARDS
    run = ClassificationRun(cfg, device="cuda", mesh_devices=[torch.device("cuda", 0)] * 8)
    run.execute()
    torch.cuda.synchronize()
    emit("sharded_reference", t0, mesh=run.mesh.shape, stage_s=run.timings)


PANEL_GENOMES = 24  # the Zymo panel's genome count (bench.py:49)
PANEL_LEN = (1_000_000, 3_000_000)  # bp; about 48 Mbp in all, the panel's order


def synthetic_panel(root: str, seed: int, n_genomes: int = PANEL_GENOMES,
                    lengths: tuple = PANEL_LEN) -> tuple:
    """A seeded stand-in for the Zymo panel the bench reads (its genomes
    are in neither the repository nor the card's machine): `n_genomes`
    random genomes of one sequence each, lengths drawn from `lengths`, as
    ``root/genomes/<acc>/<acc>_x_genomic.fna.gz`` (gzip level 1), and
    ``root/refs.tsv`` giving each accession a species of ``zymo_taxdb()``,
    round-robin. Returns (genome glob, refs.tsv path) for
    ``bench.GENOME_GLOB`` and ``bench.REFS_TSV``."""
    from hymet_tpu_torch.data.zymo_taxonomy import zymo_taxdb

    taxdb = zymo_taxdb()
    species = [t for t, r in taxdb.rank.items() if r == "species"]
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    rows = ["assembly_accession\ttaxid"]
    for i in range(n_genomes):
        acc = f"GCF_{900000 + i:09d}.1"
        os.makedirs(os.path.join(root, "genomes", acc), exist_ok=True)
        seq = acgt[rng.integers(0, 4, int(rng.integers(lengths[0], lengths[1] + 1)))]
        with gzip.open(os.path.join(root, "genomes", acc, f"{acc}_x_genomic.fna.gz"), "wb",
                       compresslevel=1) as f:
            f.write(f">{acc}.seq1 synthetic genome {i}\n".encode() + seq.tobytes() + b"\n")
        rows.append(f"{acc}\t{species[i % len(species)]}")
    refs = os.path.join(root, "refs.tsv")
    with open(refs, "w") as f:
        f.write("\n".join(rows) + "\n")
    return os.path.join(root, "genomes", "*", "*.fna.gz"), refs


def topk_edge_sets(seed: int = 0) -> list:
    """(name, codes [B, L] uint8, k, cand, s) for ``sketch_batch_topk`` and
    ``finish_bottom_sketch``: at k = 15, 21, 31 a random row, one with N
    runs, one mostly N (fewer valid windows than the pool), poly-A (a full
    pool of one hash) and a tandem repeat (a full pool of few hashes), the
    last two warning; rows with fewer windows than `cand`, at s = 50 and at
    s = the first row's distinct k-mers (every window in the pool: its s-th
    hash ties the pool's last high limb, a warning)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in (15, 21, 31):
        rows = rng.integers(0, 4, size=(5, 3000)).astype(np.uint8)
        for start in (100, 640, 1999):
            rows[1, start : start + int(rng.integers(1, 60))] = 4
        rows[2, 80:] = 4
        rows[3] = 0
        unit = rng.integers(0, 4, size=97).astype(np.uint8)
        rows[4] = np.tile(unit, -(-3000 // unit.size))[:3000]
        out.append((f"edge rows k={k}", rows, k, 250, 97))
    short = rng.integers(0, 4, size=(3, 140)).astype(np.uint8)
    short[1, 60:70] = 4
    short[2] = 4
    out.append(("short rows", short, 21, 300, 50))
    distinct = int(np.unique(kmer_hashes_numpy(short[0], 21)).size)
    out.append(("short rows, tie at the cutoff", short, 21, 300, distinct))
    return out


def finish_warned(cand_hi: torch.Tensor, cand_lo: torch.Tensor, s: int) -> tuple:
    """finish_bottom_sketch of candidates on the card: (sketch, counts,
    the warnings' messages)."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out, n = finish_bottom_sketch(cand_hi.cpu().numpy(), cand_lo.cpu().numpy(), s)
    return out, n, [str(w.message) for w in rec]


def check_topk(name: str, codes: torch.Tensor, k: int, cand: int, s: int) -> list:
    """sketch_batch_topk with the kmer_hashes kernel against the same
    selection over the plain hash (both on the card), element for element,
    and the two finished sketches, counts and warnings equal. Returns the
    warnings."""
    got = sketch_batch_topk(codes, k, cand)
    want = sketch_batch_topk(codes, k, cand, hash_fn=kmer_hashes_torch)
    check_equal(f"sketch_batch_topk, {name}", got, want)
    a, b = finish_warned(*got, s), finish_warned(*want, s)
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2]):
        raise AssertionError(f"finish_bottom_sketch, {name}: differs from the plain version's")
    return a[2]


# the kernels each bench mode may launch (any other must stay at 0)
BENCH_KERNELS = {
    "sketch": ("kmer_hash", "screen_count"),  # the DB build, the screen
    "sketch_stages": ("kmer_hash", "screen_count"),
    "sketch_large": ("screen_count",),
    "align": ("minimizers", "anchors", "chains"),  # and the index build's minimizers
    "align_stages": ("minimizers", "anchors", "chains"),
    # the world's three DB builds (sketch_codes), then the runs
    "warm_pipeline": ("screen_count", "minimizers", "anchors", "chains", "lca", "sketch_codes"),
    "pipeline": ("screen_count", "minimizers", "anchors", "chains", "lca", "sketch_codes"),
}
BENCH_RUN_KERNELS = ("screen_count", "minimizers", "anchors", "chains", "lca")
BENCH_LOG_KEYS = ("groups", "stage", "marginal", "best", "runs:", "timed run",
                  "warmup", "warm run", "species", "device-sketched", "flat DB", "index",
                  "sample", "built", "simulated", "link-excluded", "finalize")


def launches_of_runs(runs: list, execute):
    """`execute` appending each run's outdir, seconds, launches (the counts'
    growth over the run, none set to 0) and fallback to `runs`."""
    def run(self):
        torch.cuda.synchronize()
        before, t = all_launches(), time.perf_counter()
        out = execute(self)
        torch.cuda.synchronize()
        after = all_launches()
        runs.append({"outdir": self.cfg.outdir, "s": time.perf_counter() - t,
                     "launches": {k: after[k] - before[k] for k in after},
                     "fallback_ran": self.fallback_ran})
        return out
    return run


def bench_mode(mode: str, logs: list) -> dict:
    """One mode of the port bench in this process, every launch count set
    to 0 just before and read just after; its result, seconds, launches,
    the calls that launch the kernels (update_codes, sketch_batch_topk,
    the aligner's dispatches, each run's launches) and its log lines."""
    calls = Counter()

    def counted(key, fn):
        def call(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return call

    runs: list = []
    lines: list = []

    def log(msg):
        lines.append(msg)
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    with ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            ScreenEngine, "update_codes", counted("update_codes", ScreenEngine.update_codes)))
        stack.enter_context(mock.patch("hymet_tpu_torch.ops.sketch.sketch_batch_topk",
                                       counted("sketch_batch_topk", sketch_batch_topk)))
        stack.enter_context(mock.patch.object(
            MinimizerAligner, "_dispatch_fused",
            counted("dispatch_fused", MinimizerAligner._dispatch_fused)))
        stack.enter_context(mock.patch.object(bench, "log", log))
        stack.enter_context(mock.patch.object(ClassificationRun, "execute",
                                              launches_of_runs(runs, ClassificationRun.execute)))
        torch.cuda.synchronize()
        zero_launches()
        t = time.perf_counter()
        result = bench.MODES[mode](torch.device("cuda"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = all_launches()
    rec = {"mode": mode, "result": result, "s": seconds, "launches": launches, "calls": dict(calls),
           "log": [ln for ln in lines if ln.startswith(BENCH_LOG_KEYS)]}
    if runs:
        # each run counted from 0: every kernel of the run, no kmer_hashes
        checked_runs(runs, len(runs), BENCH_RUN_KERNELS, idle=("kmer_hash",))
        rec["runs"] = [{"s": r["s"], "launches": {k: r["launches"][k] for k in BENCH_RUN_KERNELS}}
                       for r in runs]
    logs.append(rec)
    return rec


def check_bench_launches(rec: dict) -> None:
    """A mode's launches against the calls that make them: the sketch DB
    build's kmer_hashes one a sketch_batch_topk call (ceil(refs / 8)),
    screen_count one an update_codes, anchors and chains one an aligner
    dispatch and minimizers at least that (the card's index build adds
    its own), every kernel of the run in the pipeline modes; any kernel
    outside the mode's set 0."""
    mode, n, c = rec["mode"], rec["launches"], rec["calls"]
    d = c.get("dispatch_fused", 0)
    ok = {
        "sketch": n["kmer_hash"] == c.get("sketch_batch_topk", 0) == -(-bench.N_REFS // 8)
        and n["screen_count"] == c.get("update_codes", 0) > 0,
        "sketch_stages": n["kmer_hash"] >= 7 and n["screen_count"] >= 7,
        "sketch_large": n["screen_count"] == c.get("update_codes", 0) > 0,
        "align": n["anchors"] == n["chains"] == d > 0 and n["minimizers"] >= d,
        "align_stages": n["chains"] >= d > 0 and n["anchors"] > d and n["minimizers"] > d,
    }.get(mode, all(n[k] > 0 for k in BENCH_RUN_KERNELS))
    if not ok or any(v for k, v in n.items() if k not in BENCH_KERNELS[mode]):
        raise AssertionError(f"bench {mode}: launches {n} against calls {c}")


def bench_world_classification(w: dict, outdir: str, scratch: str) -> float:
    """A pipeline run's TSV against classify_paf of its own PAF on the
    CPU (with its reference's detailed_taxonomy.tsv and the world's
    taxonomy); its species accuracy on the simulated truth."""
    cpu = os.path.join(scratch, "bench_classified_cpu.tsv")
    detailed = sorted(glob.glob(os.path.join(w["world"], "cache", "*", "detailed_taxonomy.tsv")))
    if len(detailed) != 1:
        raise AssertionError(f"bench world: {len(detailed)} cached references")
    classify_paf(os.path.join(outdir, "work", "resultados.paf"), detailed[0],
                 os.path.join(w["tax_dir"], "taxonomy_hierarchy.tsv"), cpu, device="cpu")
    tsv = os.path.join(outdir, "classified_sequences.tsv")
    if not filecmp.cmp(tsv, cpu, shallow=False):
        raise AssertionError(f"{outdir}: the TSV differs from the CPU re-classification")
    return bench._species_accuracy(w, tsv)


def phase_bench(tmp: str, seed: int, sms: int, clock_hz: float) -> dict:
    """Phase 15: the port's bench (``python -m hymet_tpu_torch.bench``)."""
    t0 = time.perf_counter()
    cuda = torch.device("cuda")
    root = os.path.join(tmp, "bench")
    os.makedirs(root)
    t = time.perf_counter()
    panel_glob, refs_tsv = synthetic_panel(os.path.join(root, "panel"), seed)
    panel_s = time.perf_counter() - t
    # sketch_batch_topk with the kmer_hashes kernel against its plain
    # version: the edge rows, then the sketch mode's first DB chunk
    topk_cases = []
    for name, codes, k, cand, s in topk_edge_sets(seed):
        warned = check_topk(name, torch.from_numpy(codes).cuda(), k, cand, s)
        topk_cases.append([name, *codes.shape, k, cand, s, warned])
    expect = [1, 1, 1, 0, 1]  # the edge sets at k = 15, 21, 31 warn; short rows only at the tie
    if [len(c[-1]) for c in topk_cases] != expect:
        raise AssertionError(f"sketch_batch_topk warnings {topk_cases}")
    refs = bench.sketch_refs()
    chunk = torch.from_numpy(refs[:8]).cuda()
    if check_topk("the sketch mode's first chunk", chunk, 21, 2 * bench.SKETCH_S + 256,
                  bench.SKETCH_S):
        raise AssertionError("the sketch mode's first chunk warned")
    topk = {"ms": cuda_ms(lambda: sketch_batch_topk(chunk, 21, 2 * bench.SKETCH_S + 256), iters=5),
            "plain_ms": cuda_ms(lambda: sketch_batch_topk(chunk, 21, 2 * bench.SKETCH_S + 256,
                                                          hash_fn=kmer_hashes_torch), iters=3)}
    hash_ = {"shape": list(chunk.shape), "k": 21,
             "ms": cuda_ms(lambda: hash_kernels.kmer_hashes(chunk, 21), iters=10),
             "plain_ms": cuda_ms(lambda: kmer_hashes_torch(chunk, 21), iters=3, warmup=1)}
    hash_["bound_ms"], hash_["bound_by"] = hash_bound_ms([tuple(chunk.shape)], 21, sms, clock_hz)
    del chunk

    # every mode in this process, with a cold cache of its own and the
    # synthetic panel in place of the Zymo genomes
    logs: list = []
    with mock.patch.multiple(bench, CACHE=os.path.join(root, "cache"), GENOME_GLOB=panel_glob,
                             REFS_TSV=refs_tsv):
        os.makedirs(bench.CACHE)
        for mode in ("sketch", "sketch_stages", "sketch_large", "align", "align_stages",
                     "warm_pipeline", "pipeline"):
            check_bench_launches(bench_mode(mode, logs))
            torch.cuda.empty_cache()
        # the sketch mode's DB, built through sketch_batch_topk and
        # finish_bottom_sketch, against sketch_codes of the same references
        db = SketchDB.load(bench.sketch_db_path())
        for base in range(0, bench.N_REFS, 8):
            h, n = sketch_kernels.sketch_codes(torch.from_numpy(refs[base : base + 8]).cuda(), 21,
                                               bench.SKETCH_S)
            if not (np.array_equal(db.hashes[base : base + 8].view(np.int64), h.cpu().numpy())
                    and np.array_equal(db.n_hashes[base : base + 8], n.cpu().numpy())):
                raise AssertionError(f"bench sketch DB rows {base}..: differ from sketch_codes")
        w = bench._build_world(cuda)
        accuracy = bench_world_classification(w, os.path.join(w["world"], "out_timed"), root)
        if accuracy < 0.9:
            raise AssertionError(f"bench pipeline: species accuracy {accuracy}")
    del refs

    # one child as a user runs it: the sketch mode at its defaults, its
    # cache the checkout's build/bench_cache_torch
    env = {k: v for k, v in os.environ.items() if not k.startswith(("_BENCH_", "BENCH_"))}
    t = time.perf_counter()
    child = subprocess.run([sys.executable, "-m", "hymet_tpu_torch.bench"], cwd=REPO,
                           env={**env, "BENCH_MODE": "sketch", "PYTHONPATH": REPO},
                           capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t
    lines = [ln for ln in child.stdout.splitlines() if ln.strip()]
    if child.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench child: exit {child.returncode}, stdout {child.stdout!r}, "
                             f"stderr tail {child.stderr[-3000:]!r}")
    line = json.loads(lines[0])
    if line.get("metric") != "sketch_query_Gbp_per_s" or "degraded" in line or line["value"] <= 0:
        raise AssertionError(f"bench child: {line}")
    emit("bench", t0, panel_s=panel_s, topk_cases=topk_cases, sketch_batch_topk=topk,
         kmer_hash_bench_chunk=hash_, modes=logs, accuracy=accuracy,
         child={"s": child_s, "line": line})
    return {"modes": {r["mode"]: r for r in logs}, "kmer_hash": hash_}


def all_phases(tmp: str, seed: int, sms: int, clock_hz: float) -> tuple:
    """Phases 3 to 15 in `tmp`: what the kernels line reads."""
    cfg = RunConfig()
    kernels = phase_kernel(seed, cfg, sms, clock_hz)
    small_ref, launches = phase_slice(tmp, cfg)
    phase_scale(tmp, cfg, seed, small_ref, kernels["screen_count"]["ms"])
    index, staged, align_launched, combined = phase_align(tmp, cfg)
    align_stats = phase_align_kernels(seed, cfg, index, staged, combined, sms, clock_hz)
    gut = phase_run(tmp)
    lca_stats = phase_lca(seed, gut, sms, clock_hz)
    traced = phase_profile(tmp, gut)
    db = phase_db(tmp, sms, clock_hz)
    phase_eval(tmp, seed)
    phase_harness(tmp)
    sharded = phase_sharded(tmp, seed, cfg)
    dist = phase_distributed(tmp)
    bench_ = phase_bench(tmp, seed, sms, clock_hz)
    return (kernels, launches, align_launched, align_stats, gut, lca_stats, db, sharded, dist,
            bench_, traced)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=["distributed", "bench", "profile"],
                    help="distributed: phases 1 and 2, phase 13's run at db_shards = 4 alone, "
                         "and phase 14; bench: phases 1, 2 and 15; profile: phases 1, 2, 8 and "
                         "16; each prints no kernels line and no ok line")
    ap.add_argument("--worker", nargs=4, metavar=("RANK", "WORLD", "PORT", "DIR"),
                    help=argparse.SUPPRESS)  # one process of phase 14
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    if args.worker:
        rank, world, port, root = args.worker
        return dist_worker(int(rank), int(world), int(port), root)
    t_start = t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    emit("device", t0, name=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         sms=sms, clock_max_sm_mhz=clock_mhz, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib = hash_kernels.load_library()
    emit("build", t0, nvcc_s=lib.build_s, library=os.path.relpath(lib.path, REPO),
         ptxas=[ln.strip() for ln in lib.log.splitlines() if "ptxas" in ln or "spill" in ln],
         native_host_helpers=native_check())
    tmp = tempfile.mkdtemp(prefix="hymet_chip_smoke_")
    try:
        if args.only == "distributed":
            sharded_reference_run(tmp)
            phase_distributed(tmp)
        elif args.only == "bench":
            phase_bench(tmp, args.seed, sms, clock_mhz * 1e6)
        elif args.only == "profile":
            phase_profile(tmp, phase_run(tmp))
        else:
            (kernels, launches, align_launched, align_stats, gut, lca_stats, db, sharded, dist,
             bench_, traced) = all_phases(tmp, args.seed, sms, clock_mhz * 1e6)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("total", t_start)
    print(smi)
    if args.only:
        return 0  # a partial run: neither the kernels line nor the contract's last line

    def bench_launches(name: str) -> dict:
        return {mode: r["launches"][name] for mode, r in bench_["modes"].items()}

    def profiled(name: str) -> dict:
        """Phase 16's launches of the kernel in the profiled run's stages
        and the activities their traces show."""
        return {"profile_launches": traced["launches"].get(name, 0),
                "profile_traced": traced["traced"].get(name, 0)}

    print(json.dumps({"kernels": [
        # the DB build's path (phase 10): its launches and its batches' times
        {"name": "sketch_codes", "route": "cuda",
         "source": "hymet_tpu_torch/csrc/bottom_sketch.cu",
         "replaces": "hymet_tpu/ops/sketch.py:919 with hymet_tpu/ops/pallas_kernels.py:35 fused in",
         "launches": db["launches"]["sketch_codes"], "main_path": True,
         "distributed_launches": [r["launches"]["sketch_codes"] for r in dist],
         "bench_launches": bench_launches("sketch_codes"),
         "sharded_launches": sharded["sketch_codes"], **profiled("sketch_codes"),
         **db["sketch_codes"],
         "max_abs_err": max(db["sketch_codes"]["max_abs_err"],
                            kernels["sketch_codes"]["max_abs_err"]),
         "library_ms": None},
        # the Pallas kernel's standalone counterpart: on the bench's sketch
        # DB build (phase 15; its launches there), its times on the run's
        # DB build batches (phase 10) and the bench's chunk
        {"name": "kmer_hash", "route": "cuda", "source": "hymet_tpu_torch/csrc/kmer_hash.cu",
         "replaces": "hymet_tpu/ops/pallas_kernels.py:35",
         "launches": bench_["modes"]["sketch"]["launches"]["kmer_hash"], "main_path": True,
         "db_build_launches": db["launches"]["kmer_hash"], "bench_chunk": bench_["kmer_hash"],
         "distributed_launches": [r["launches"]["kmer_hash"] for r in dist],
         "bench_launches": bench_launches("kmer_hash"),
         "sharded_launches": sharded["kmer_hash"], **profiled("kmer_hash"),
         **db["kmer_hash"], "max_abs_err": max(db["kmer_hash"]["max_abs_err"],
                                               kernels["kmer_hash"]["max_abs_err"]),
         "library_ms": None},
        {"name": "screen_count", "route": "cuda", "source": "hymet_tpu_torch/csrc/screen_count.cu",
         "replaces": "hymet_tpu/ops/pallas_kernels.py:35",
         "launches": launches["screen_count"], "main_path": True,
         "distributed_launches": [r["launches"]["screen_count"] for r in dist],
         "bench_launches": bench_launches("screen_count"),
         "sharded_launches": sharded["screen_count"], **profiled("screen_count"),
         **kernels["screen_count"], "library_ms": None},
        *({"name": name, "route": "cuda", "source": f"hymet_tpu_torch/csrc/{name}.cu",
           "replaces": replaces, "launches": align_launched[name], "main_path": True,
           "sharded_launches": sharded[name],
           "distributed_launches": [r["launches"][name] for r in dist],
           "bench_launches": bench_launches(name), **profiled(name),
           **align_stats[name]}
          for name, replaces in (
              ("minimizers", "hymet_tpu/ops/minimizer.py:241"),
              ("anchors", "hymet_tpu/models/aligner.py:391, :509 (its lax.sort :696)"),
              ("chains", "hymet_tpu/models/aligner.py:709"))),
        {"name": "lca", "route": "cuda", "source": "hymet_tpu_torch/csrc/lca.cu",
         "replaces": "hymet_tpu/ops/lca.py:40", "launches": gut["launches"], "main_path": True,
         "distributed_launches": [r["launches"]["lca"] for r in dist],
         "bench_launches": bench_launches("lca"),
         "sharded_launches": sharded["lca"], **profiled("lca"),
         **lca_stats},
        {"name": "bottom_sketch", "route": "cuda", "source": "hymet_tpu_torch/csrc/bottom_sketch.cu",
         "replaces": "hymet_tpu/ops/sketch.py:919", "launches": db["launches"]["bottom_sketch"],
         "main_path": True, "distributed_launches": [r["launches"]["bottom_sketch"] for r in dist],
         "bench_launches": bench_launches("bottom_sketch"),
         "sharded_launches": sharded["bottom_sketch"], **profiled("bottom_sketch"),
         **db["bottom_sketch"],
         "max_abs_err": max(db["bottom_sketch"]["max_abs_err"],
                            kernels["bottom_sketch"]["max_abs_err"])},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
