"""End-to-end classification run: the ``run_hymet_cami.sh`` replacement
(counterpart of hymet_tpu.pipeline.run).

    ClassificationRun(config, device="cuda").execute()

With ``config.db_shards > 1`` (``HYMET_DB_SHARDS``) and at least that many
devices, the screen and the aligner shard the reference over a ("data",
"db") mesh (:mod:`hymet_tpu_torch.parallel`); with fewer devices the run
logs a warning and runs on one.

Under a process group of more than one process
(:func:`hymet_tpu_torch.parallel.distributed.init_distributed`), every
process runs every stage: the mesh spans every process's devices, the
sharded stages gather across processes, and the host stages compute the
same result in each. Process 0's files are the canonical output; process
``i > 0`` writes to ``outdir + ".proc<i>"`` and ``cache_root +
".proc<i>"``. A barrier ends the run.

Stage layout and intermediate files mirror the reference batch script:

  0. upload-once contig staging (screen and align read the same device
     batches; not under a mesh)
  1. sketch screen over 1..N sketch DBs -> selected_genomes.txt
     (``run_hymet_cami.sh:82-99``)
  2. candidate limiting (``:101-126``)
  3. reference set build, cached content-addressed by
     sha1(selected_genomes.txt) (``:129-165``), or a preset combined FASTA
  4. minimizer index + mapping -> resultados.paf (``:167-171``; the .mmi
     cache becomes a .npz minimizer-index cache, and the aligner stays
     resident on the device between runs of one process)
  5. weighted-LCA classification -> classified_sequences.tsv (``:174-180``;
     ``classifier_backend="legacy"``: ``classification.py``'s classifier,
     as ``main.pl:113`` runs it) with the first-hit fallback when <2 rows
     (``:182-206``)
  6. CAMI export -> hymet.<sample>.cami.tsv (``:214-218``)

Every stage is idempotent: outputs found on disk are reused (the
reference's stage-skip semantics). Each stage's seconds (ending in a
device synchronize) land in ``timings`` and ``metadata.json``.

``HYMET_PROFILE_WEIGHT=length`` weights the CAMI profile by contig
length, as the JAX run does.

``HYMET_PROFILE`` traces each stage: unset or empty, no trace; ``1``, the
root ``<outdir>/logs/profile``; any other value is the root itself. Each
stage then runs inside ``torch.profiler.profile`` (host activity, and the
card's where the run's device is a card; on the card the trace opens with
a lead, :func:`profile_lead`, so that the stage's first kernels are in
it, and the stage's closing synchronize is inside it, so that its last
kernels are) and writes one
gzipped Chrome trace, ``<root>/<stage>/plugins/profile/<timestamp>/
<host>.trace.json.gz`` (``<host>.proc<i>`` for process ``i`` of a group),
the layout of the JAX run's ``jax.profiler`` traces. The stage's seconds
include the profiler's cost and not the lead's (its measured seconds, a
stage each, are in ``lead_s``). A trace opens in Perfetto
(ui.perfetto.dev) or ``chrome://tracing``. A profiler that fails to start
or to write raises: the run does not go on untraced.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
import socket
import time

import torch

from hymet_tpu_torch.evalx.cami import classified_to_cami
from hymet_tpu_torch.io.fasta import read_fasta
from hymet_tpu_torch.io.sketchdb import load_sketch_db
from hymet_tpu_torch.models.aligner import AlignerConfig, MinimizerAligner
from hymet_tpu_torch.models.first_hit import (
    build_id_map,
    classify_first_hit,
    write_fallback_classified,
)
from hymet_tpu_torch.models.legacy_lca import classify_paf_legacy
from hymet_tpu_torch.models.weighted_lca import BACKENDS, classify_paf
from hymet_tpu_torch.ops.hash_kernels import KernelError
from hymet_tpu_torch.ops.lca import LCA_MAX_BUCKET
from hymet_tpu_torch.parallel.distributed import (
    all_gather, barrier, local_card, process_count, process_index)
from hymet_tpu_torch.parallel.mesh import global_devices, make_mesh
from hymet_tpu_torch.pipeline.align_stage import (
    index_cache_path,
    load_or_build_index,
    run_align_stage,
)
from hymet_tpu_torch.pipeline.candidates import limit_candidates_files
from hymet_tpu_torch.pipeline.reference_stage import (
    AssemblySummarySource,
    LocalGenomeCatalog,
    build_reference_from_combined,
    build_reference_set,
)
from hymet_tpu_torch.pipeline.screen_stage import run_screen_stage
from hymet_tpu_torch.pipeline.staged import StagedContigs
from hymet_tpu_torch.taxonomy.db import TaxonomyDB
from hymet_tpu_torch.utils.config import RunConfig
from hymet_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("hymet_tpu_torch.run")

# Device-resident aligner cache (see _stage_align): (index path, mtime,
# size, aligner config, k/w, device) -> MinimizerAligner whose search
# tables already live on the device. A small LRU: a serving process maps
# many samples against one candidate index, and two slots cover
# alternating samples. HYMET_RESIDENT_INDEX=0 turns it off.
_RESIDENT_ALIGNERS: dict = {}
_RESIDENT_MAX = 2

# HYMET_PROFILE on the card: a stage's trace opens with PROFILE_LEAD_S of
# one-element copies, PROFILE_LEAD_STEPS of them, before the stage runs.
# On the H100 torch.profiler loses a trace's first device records (most
# stage traces lost their first three) and drops a record stamped before
# the trace's start, and a trace's device stamps sometimes lie before
# their launches, by up to 76 ms seen (tools/profile_loss.py measures
# both): the lead's copies take those losses, and its time the early
# stamps.
PROFILE_LEAD_S = 0.5
PROFILE_LEAD_STEPS = 10


def profile_lead(device: torch.device) -> None:
    """The lead of a trace on the card (PROFILE_LEAD_S, PROFILE_LEAD_STEPS)."""
    for _ in range(PROFILE_LEAD_STEPS):
        torch.zeros(1, device=device).cpu()
        time.sleep(PROFILE_LEAD_S / PROFILE_LEAD_STEPS)

# Failures the first-hit fallback must not hide: a kernel that does not
# build or launch, and the card's own errors.
_DEVICE_ERRORS = (KernelError, torch.cuda.OutOfMemoryError) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ()
)


def _device_fault(e: BaseException) -> bool:
    return isinstance(e, _DEVICE_ERRORS) or (isinstance(e, RuntimeError) and "CUDA" in str(e))


def _resident_key(idx_path: str, aln_cfg: AlignerConfig, cfg: RunConfig, dev: torch.device):
    if os.environ.get("HYMET_RESIDENT_INDEX", "1") != "1":
        return None
    try:
        st = os.stat(idx_path)
    except OSError:
        return None
    return (os.path.abspath(idx_path), st.st_mtime_ns, st.st_size, repr(aln_cfg),
            (cfg.align_k, cfg.align_w), str(dev))


def _resident_aligner_get(idx_path, aln_cfg, cfg, dev):
    key = None if cfg.force_download else _resident_key(idx_path, aln_cfg, cfg, dev)
    aligner = _RESIDENT_ALIGNERS.pop(key, None)
    if aligner is not None:  # LRU refresh
        _RESIDENT_ALIGNERS[key] = aligner
    return aligner


def _resident_aligner_put(idx_path, aln_cfg, cfg, dev, aligner) -> None:
    key = _resident_key(idx_path, aln_cfg, cfg, dev)
    if key is None:
        return
    _RESIDENT_ALIGNERS[key] = aligner
    while len(_RESIDENT_ALIGNERS) > _RESIDENT_MAX:
        _RESIDENT_ALIGNERS.pop(next(iter(_RESIDENT_ALIGNERS)))


def _count_lines(path: str) -> int:
    if not os.path.exists(path):
        return 0
    with open(path, "rb") as f:
        return sum(1 for _ in f)


class ClassificationRun:
    """One sample's run on `device` (default the card; raises without
    one). ``timings`` holds each stage's seconds; ``fallback_ran`` says
    whether the first-hit fallback wrote the classification.

    ``mesh_devices`` (keyword-only; repeats allowed) are the devices a
    ``db_shards > 1`` mesh may use: by default every visible card for a
    CUDA `device`, and `device` alone for the CPU (so a CPU run falls back
    to one device, as a one-device JAX host does). In a process group they
    are this process's devices (by default `device`, where a bare "cuda"
    is the process's own card, :func:`local_card`), and the mesh spans
    every process's: every process must construct the run and execute it.
    """

    def __init__(self, config: RunConfig, device="cuda", *, mesh_devices=None):
        if config.classifier_backend not in (*BACKENDS, "legacy"):
            raise ValueError(f"unknown classifier_backend {config.classifier_backend!r}")
        self.cfg = config
        self.dev = resolve_device(device)
        self._setup_multihost()
        if self._multihost and self.dev.type == "cuda" and self.dev.index is None:
            self.dev = local_card()
        self.mesh = self._make_mesh(mesh_devices)
        self.workdir = os.path.join(self.cfg.outdir, "work")
        self.timings = {}
        self.lead_s = {}  # HYMET_PROFILE on the card: each stage's profile_lead seconds
        self.fallback_ran = False
        self._staged = None  # upload-once contig batches (_stage_contigs)
        self._contigs = None  # (names, seqs) read once for both stages

    def _setup_multihost(self) -> None:
        """In a group of more than one process, point a non-primary
        process's writes at its own outdir and cache root."""
        self._multihost = process_count() > 1
        pid = process_index()
        if not self._multihost or pid == 0:
            return
        cfg = self.cfg
        self.cfg = dataclasses.replace(cfg, outdir=f"{cfg.outdir}.proc{pid}",
                                       cache_root=f"{cfg.cache_root}.proc{pid}")
        logger.info("multihost: process %d writes to %s", pid, self.cfg.outdir)

    def _make_mesh(self, mesh_devices):
        """("data", "db") mesh when db_shards > 1 and enough devices exist
        (data = devices // db_shards, over every process's devices in a
        group); None = one device."""
        shards = self.cfg.db_shards
        if shards <= 1:
            return None
        if mesh_devices is not None:
            local = list(mesh_devices)
        elif self.dev.type == "cuda" and not self._multihost:
            local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            local = [self.dev]
        devs, owners = global_devices(local)
        if len(devs) < shards:
            logger.warning("db_shards=%d but only %d devices; running single-device",
                           shards, len(devs))
            return None
        n = max(1, len(devs) // shards) * shards
        return make_mesh(data=n // shards, db=shards, devices=devs[:n], owners=owners[:n])

    def _have(self, path: str) -> bool:
        """Whether a stage's output `path` is on disk and not empty: in
        every process, when the stage gathers across processes (a process
        that skipped it would leave the others waiting in its gathers)."""
        have = os.path.exists(path) and os.path.getsize(path) > 0
        if self._multihost and self.mesh is not None:
            return all(all_gather(have))
        return have

    # ------------------------------------------------------------------

    def execute(self) -> str:
        """Run all stages; returns the path to classified_sequences.tsv."""
        cfg = self.cfg
        if not cfg.input_fasta or not os.path.exists(cfg.input_fasta):
            raise FileNotFoundError(f"missing FASTA {cfg.input_fasta}")
        os.makedirs(self.workdir, exist_ok=True)
        os.makedirs(os.path.join(cfg.outdir, "logs"), exist_ok=True)

        self._stage_contigs()
        if cfg.reference_fasta:
            # preset combined reference: candidate selection is moot
            combined, taxonomy_tsv = self._stage_reference_preset()
        else:
            selected_path = self._stage_screen()
            self._stage_limit(selected_path)
            combined, taxonomy_tsv = self._stage_reference(selected_path)
        paf_path = self._stage_align(combined)
        classified = self._stage_classify(paf_path, taxonomy_tsv)
        self._stage_export(classified)
        self._write_metadata()
        barrier()
        return classified

    # ------------------------------------------------------------------

    def _timed(self, name: str, fn):
        self.lead_s.pop(name, None)
        t0 = time.time()
        root = self._profile_root()
        if root:
            out = self._profiled(name, os.path.join(root, name), fn)
        else:
            out = fn()
            self._sync_device()
        self.timings[name] = time.time() - t0 - self.lead_s.get(name, 0.0)
        logger.info("[stage %s] %.2fs", name, self.timings[name])
        return out

    def _sync_device(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _profile_root(self):
        """The per-stage trace root that ``HYMET_PROFILE`` names, or None."""
        flag = os.environ.get("HYMET_PROFILE", "")
        if not flag:
            return None
        if flag == "1":
            return os.path.join(self.cfg.outdir, "logs", "profile")
        return flag

    def _takes_lead(self) -> bool:
        """Whether a stage's trace opens with :func:`profile_lead`: on the
        card, whose profiler loses a trace's first records."""
        return self.dev.type == "cuda"

    def _profiled(self, name: str, stage_dir: str, fn):
        """fn() under torch.profiler, its device synchronized inside the
        window; writes the stage's gzipped Chrome trace under `stage_dir`."""
        from torch.profiler import ProfilerActivity, profile, record_function

        card = self.dev.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
        with profile(activities=activities) as prof:
            if self._takes_lead():
                t = time.time()
                profile_lead(self.dev)
                self.lead_s[name] = time.time() - t
            with record_function(f"stage {name}"):
                out = fn()
                self._sync_device()
        host = socket.gethostname()
        if self._multihost:
            host += f".proc{process_index()}"
        trace_dir = os.path.join(stage_dir, "plugins", "profile",
                                 time.strftime("%Y_%m_%d_%H_%M_%S"))
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"{host}.trace.json.gz")
        prof.export_chrome_trace(path)
        logger.info("[stage %s] trace %s", name, path)
        return out

    def _query_contigs(self):
        """(names, seqs) of the sample, read once."""
        if self._contigs is None:
            self._contigs = read_fasta(self.cfg.input_fasta)
        return self._contigs

    def _stage_contigs(self) -> None:
        """Upload-once contig staging (pipeline/staged.py): read, pack and
        upload the sample a single time for both device stages. Not under
        a mesh: the sharded engines ship their own batches."""
        cfg = self.cfg
        if self.mesh is not None:
            return

        def run():
            qnames, qseqs = read_fasta(cfg.input_fasta)
            self._contigs = (qnames, qseqs)
            self._staged = StagedContigs(
                qnames, qseqs, cfg.align_batch_pad, cfg.align_k + cfg.align_w, device=self.dev
            )
            logger.info(
                "staged %d contigs: %d device batches, %.1f MB packed "
                "(uploaded once for screen + align)",
                len(qseqs),
                len(self._staged.device),
                self._staged.packed_bytes / 1e6,
            )

        self._timed("upload", run)

    def _stage_screen(self) -> str:
        cfg = self.cfg
        selected = os.path.join(self.workdir, "selected_genomes.txt")
        if self._have(selected):
            logger.info("screen outputs exist; skipping")
            return selected

        def run():
            dbs = [load_sketch_db(p) for p in cfg.sketch_dbs]
            if not dbs:
                raise RuntimeError("no sketch DBs configured (cfg.sketch_dbs)")
            labels = [
                os.path.splitext(os.path.basename(p))[0] for p in cfg.sketch_dbs
            ]
            return run_screen_stage(
                dbs,
                [cfg.input_fasta],
                self.workdir,
                initial_threshold=cfg.mash_thresh,
                db_labels=labels,
                chunk_bp=cfg.screen_chunk_bp,
                staged=self._staged,
                device=self.dev,
                mesh=self.mesh,
            )

        self._timed("screen", run)
        return selected

    def _stage_limit(self, selected_path: str) -> None:
        cfg = self.cfg
        score_files = [
            os.path.join(self.workdir, f)
            for f in os.listdir(self.workdir)
            if f.endswith("_sorted.tab")
        ]
        limited = selected_path + ".limited"
        self._timed(
            "limit",
            lambda: limit_candidates_files(
                selected_path,
                limited,
                sorted(score_files),
                max_candidates=cfg.cand_max,
                dedupe=cfg.species_dedup,
                assembly_dir=cfg.assembly_summary_dir,
                log_path=cfg.cand_limit_log,
            ),
        )
        os.replace(limited, selected_path)
        if _count_lines(selected_path) == 0:
            raise RuntimeError("candidate list empty after applying limit")

    def _stage_reference_preset(self):
        cfg = self.cfg
        src = cfg.reference_fasta
        st = os.stat(src)
        key = hashlib.sha1(
            f"{os.path.abspath(src)}:{st.st_size}:{int(st.st_mtime)}".encode()
        ).hexdigest()
        cache_dir = os.path.join(cfg.cache_root, key)
        combined = os.path.join(cache_dir, "combined_genomes.fasta")
        taxonomy = os.path.join(cache_dir, "detailed_taxonomy.tsv")
        if os.path.exists(combined) and os.path.getsize(combined) > 0:
            logger.info("preset reference cache hit for %s", key)
            return combined, taxonomy

        self._timed(
            "reference",
            lambda: build_reference_from_combined(src, cache_dir, cfg.seqid2taxid),
        )
        return combined, taxonomy

    def _cache_key(self, selected_path: str) -> str:
        with open(selected_path, "rb") as f:
            return hashlib.sha1(f.read()).hexdigest()

    def _stage_reference(self, selected_path: str):
        cfg = self.cfg
        key = self._cache_key(selected_path)
        cache_dir = os.path.join(cfg.cache_root, key)
        combined = os.path.join(cache_dir, "combined_genomes.fasta")
        taxonomy = os.path.join(cache_dir, "detailed_taxonomy.tsv")
        logger.info("cache key %s -> %s", key, cache_dir)
        if cfg.force_download:
            for p in (combined, taxonomy):
                if os.path.exists(p):
                    os.remove(p)
        if os.path.exists(combined) and os.path.getsize(combined) > 0:
            logger.info("cache hit for %s", key)
            return combined, taxonomy

        with open(selected_path) as f:
            names = [line.strip() for line in f if line.strip()]

        catalog = None
        if cfg.genome_catalog:
            if os.path.isdir(cfg.genome_catalog):
                catalog = LocalGenomeCatalog.from_directory(
                    cfg.genome_catalog, cfg.seqid2taxid
                )
            else:
                catalog = LocalGenomeCatalog.from_refs_tsv(cfg.genome_catalog)
        source = None
        if cfg.allow_download and cfg.assembly_summary_dir:
            source = AssemblySummarySource(cfg.assembly_summary_dir)

        self._timed(
            "reference",
            lambda: build_reference_set(names, cache_dir, catalog, source),
        )
        return combined, taxonomy

    def _stage_align(self, combined: str) -> str:
        cfg = self.cfg
        paf_path = os.path.join(self.workdir, "resultados.paf")
        if self._have(paf_path):
            logger.info("PAF exists; skipping alignment")
            return paf_path
        if os.path.exists(paf_path):  # another process lacks its PAF: map again, with it
            os.remove(paf_path)
        aln_cfg = AlignerConfig(batch_pad=cfg.align_batch_pad)
        # the LCA bucketer drops nothing only while the aligner's per-query
        # record cap fits its largest bucket: fail here, not with wrong
        # abundances later
        if aln_cfg.max_secondary + 1 > LCA_MAX_BUCKET:
            raise ValueError(
                f"AlignerConfig.max_secondary={aln_cfg.max_secondary} can emit "
                f"{aln_cfg.max_secondary + 1} records/query > the LCA bucket ceiling "
                f"{LCA_MAX_BUCKET} (ops/lca.py DEFAULT_BUCKETS)"
            )
        idx_path = index_cache_path(combined, cfg)

        def run():
            qnames, qseqs = self._query_contigs()
            if self.mesh is not None:  # the sharded aligner: no resident LRU
                run_align_stage(combined, qnames, qseqs, self.workdir, cfg, device=self.dev,
                                mesh=self.mesh)
                return
            aligner = _resident_aligner_get(idx_path, aln_cfg, cfg, self.dev)
            if aligner is None:
                index = load_or_build_index(combined, cfg, self.dev)
                aligner = MinimizerAligner(index, aln_cfg, device=self.dev)
                _resident_aligner_put(idx_path, aln_cfg, cfg, self.dev, aligner)
            else:
                logger.info("resident device index: %s", idx_path)
            run_align_stage(combined, qnames, qseqs, self.workdir, cfg, staged=self._staged,
                            device=self.dev, aligner=aligner)

        self._timed("align", run)
        return paf_path

    def _stage_classify(self, paf_path: str, taxonomy_tsv: str) -> str:
        cfg = self.cfg
        out = os.path.join(self.workdir, "classified_sequences.tsv")
        hierarchy = self._hierarchy_path()

        def run():
            try:
                if cfg.classifier_backend == "legacy":
                    classify_paf_legacy(paf_path, taxonomy_tsv, hierarchy, out)
                else:
                    classify_paf(paf_path, taxonomy_tsv, hierarchy, out,
                                 backend=cfg.classifier_backend, device=self.dev)
            except Exception as e:  # noqa: BLE001 — reference tolerates (|| true)
                if _device_fault(e):
                    raise
                logger.error("primary classification failed: %s", e)
            if _count_lines(out) < 2:
                logger.warning("primary classification empty -> first-hit fallback")
                self.fallback_ran = True
                id2tax = build_id_map(taxonomy_tsv)
                frows, _ = classify_first_hit(paf_path, id2tax)
                write_fallback_classified(out, frows)
                if _count_lines(out) < 2:
                    raise RuntimeError("classification still empty after fallback")
            return out

        self._timed("classify", run)
        final = os.path.join(cfg.outdir, "classified_sequences.tsv")
        if os.path.abspath(final) != os.path.abspath(out):
            shutil.copyfile(out, final)
        return final

    def _hierarchy_path(self) -> str:
        cfg = self.cfg
        if not cfg.taxonomy_dir:
            raise RuntimeError("taxonomy_dir not configured")
        # accept a prebuilt hierarchy TSV, or a taxdump dir to build from
        tsv = (
            cfg.taxonomy_dir
            if cfg.taxonomy_dir.endswith(".tsv")
            else os.path.join(cfg.taxonomy_dir, "taxonomy_hierarchy.tsv")
        )
        if os.path.exists(tsv):
            return tsv
        names_dmp = os.path.join(cfg.taxonomy_dir, "names.dmp")
        if os.path.exists(names_dmp):
            logger.info("building taxonomy hierarchy from taxdump")
            db = TaxonomyDB.from_taxdump(cfg.taxonomy_dir)
            db.write_hierarchy_tsv(tsv)
            return tsv
        raise RuntimeError(f"no taxonomy found under {cfg.taxonomy_dir}")

    def _taxdb(self) -> TaxonomyDB:
        cfg = self.cfg
        names_dmp = os.path.join(cfg.taxonomy_dir, "names.dmp") if cfg.taxonomy_dir else ""
        if names_dmp and os.path.exists(names_dmp):
            return TaxonomyDB.from_taxdump(cfg.taxonomy_dir)
        return TaxonomyDB.from_hierarchy_tsv(self._hierarchy_path())

    def _stage_export(self, classified: str) -> str:
        cfg = self.cfg
        sample = os.path.splitext(os.path.basename(cfg.input_fasta))[0]
        out = os.path.join(cfg.outdir, f"hymet.{sample}.cami.tsv")

        def run():
            # HYMET_PROFILE_WEIGHT=length emits an abundance-weighted
            # profile (CAMI convention); the default "count" keeps byte
            # parity with the reference converter (tools/hymet2cami.py).
            lengths = None
            if os.environ.get("HYMET_PROFILE_WEIGHT", "count") == "length":
                names, seqs = self._query_contigs()
                lengths = {name: len(seq) for name, seq in zip(names, seqs)}
            return classified_to_cami(classified, self._taxdb(), out, sample, lengths=lengths)

        self._timed("export", run)
        return out

    def _write_metadata(self) -> None:
        meta = {
            "tool": "hymet_tpu_torch",
            "device": str(self.dev),
            "config": {
                k: v
                for k, v in self.cfg.__dict__.items()
                if isinstance(v, (str, int, float, bool, list, type(None)))
            },
            "timings_sec": {k: round(v, 3) for k, v in self.timings.items()},
            "first_hit_fallback": self.fallback_ran,
        }
        with open(os.path.join(self.cfg.outdir, "metadata.json"), "w") as f:
            json.dump(meta, f, indent=2)
