"""Smoke run of the skyplane_tpu_torch data path and gateway on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final ``ok`` line):

1. Device, torch and CUDA versions, the card's name and power limit; build
   the CUDA kernels from ``skyplane_tpu_torch/csrc`` (one nvcc per source,
   all at once) and print the build seconds, each kernel's registers, spills
   and shared memory (ptxas), and the integer mma (IMMA) count in the SASS
   of the two fingerprint kernels, which fails if it is 0. Beside them, g++
   builds the native host library (``skyplane_tpu_torch/native``): its path,
   build seconds and whether ``-march=native`` took; it fails if the library
   is not available. Whether the system liblz4 is present.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes (B = 8 rows of an 8 MiB bucket, cap 4096, 2050 slots) with
   a zero row, a short row with its garbage end and sentinel-padded ends;
   ``gear_compact`` also at an overflowing cap of 16, at mask bits 4 (the
   cap hit mid-chunk) and over 20 repeated launches, bit for bit, and its
   device time traced; ``segment_fp`` also on four adversarial rows (ends
   at every residue mod 64 with ends 1 byte apart and at 64k - 1, 64k,
   64k + 1; all 0xFF bytes; a segment of 2^19 bytes, clamped; the bucket as
   the only end). Equality is exact (integer outputs). Each kernel and plain
   version is timed with CUDA events and printed beside its bound.
3. The main path: ``DataPathProcessor(dedup=True)`` over a
   ``DeviceBatchRunner(max_batch=8)`` with 16 sender threads, on the bench's
   snapshot-chain corpus (4 snapshots x 6 chunks x 8 MiB, seed 0), with
   fingerprints committed after each chunk, in four passes: (a) codec
   ``tpu`` with the native host library off, (b) ``tpu`` with it on (the
   main path; its launches go in the kernel line), (c) ``native_lz``, (d)
   ``lz4`` when liblz4 is present; two rounds in turns (a b c d, d c b a).
   Launch counts are zeroed just before each pass and read just after. Each
   pass prints Gbps, wire reduction, REF segments, batch windows and the
   host split: per-thread CPU and wall time of the codec, the recipe, the
   boundary selection, the staging copies, the blake2b finalize and the
   leaders' batch runs, from wrappers this script installs, and the device
   wait. Then: every chunk of each pass restores byte-identical under
   paranoid verify (timed, with the library on and off), and sampled wire
   bytes of codecs ``tpu`` and ``native_lz`` are equal across the device
   path and the host path with the library on and off.
4. One more pass of the main path under torch.profiler: the device's busy
   share of the wall time, device time by kernel or copy, and the traced
   time and launches of each kernel of the path. An error of the data path
   fails this phase like any other.
5. The fused batch step ``datapath_step`` (slice 2) at B = 8 x 8 MiB on the
   corpus's first 8 chunks, block 512, fingerprint stride 64 KiB, mask bits
   16, with launch counts zeroed just before and read just after. Its
   outputs are checked (shapes, ranges, every row's literals decode
   byte-identical through the host decoder, the ``entry()`` twin on the card
   equals its CPU run), and each of its kernels (``gear_mask``,
   ``segment_fp_fixed``, ``blockpack_encode``) equals its plain version
   exactly on those rows and on adversarial ones (all-zero, constant, a
   repeated 1 KiB pattern, random), ``segment_fp_fixed`` also at strides
   4096, 2^17, 2^19 (past the power table: clamped) and 64, and at 1000 (its
   byte path) on the rows cut to 8192000 bytes, ``blockpack_encode`` also at
   blocks 1, 4, 16, 600, 4096 and 40960 (larger than its tile) on the rows
   cut to a multiple of the block, and on the batch at storage offset 1.
   Kernel, plain and whole-step times with CUDA events, beside each
   kernel's bound; ``blockpack_encode`` also by traced device time, beside
   a device-to-device copy of the same bytes, and at the other blocks; then
   20 steps under torch.profiler: the device's busy share of their wall
   time.
6. The gateway through two port gateway daemons (slices 7 and 8):
   ``GatewayDaemon(device="cuda")`` twice, in process on threads (control
   port 0 on 127.0.0.1, plaintext control and data), each building its own
   ``DeviceBatchRunner(max_batch=8)``. The source's program is
   ``read_local`` (8 workers) -> ``send`` (16 connections, window 16, codec
   ``tpu``, dedup); the destination's is ``receive`` (dedup) ->
   ``write_local``. The corpus is written as 24 source files and dispatched
   with one ``POST /api/v1/chunk_requests`` to the source; the round ends
   when the destination's ``/api/v1/chunk_status_log`` reports all 24
   complete, and every destination file is held against its source. Each
   round starts fresh daemons (fresh runners, index and segment store). Two
   rounds with ``SKYPLANE_TPU_PARANOID_VERIFY=1`` (recipe chunks
   re-fingerprinted on the card through the destination's runner), launch
   counts zeroed just before the first and read just after the second; a
   witness round at the daemon's default (paranoid verification off); a
   traced round under torch.profiler (the device's busy share). Each round
   prints Gbps of raw bytes from the POST to the last completion, wire
   bytes, wire reduction, REF share, NACKs and resends, ack lag, each
   daemon runner's K-AB and K-C launches and ``phase.first_compile``
   interval (from ``GET /api/v1/events``), the destination's
   ``verify_counters()`` and the host split by stage; then the paranoid
   rounds beside the witness round (Gbps, ack lag, REF share, the recipe
   restore's wall) and phase 3 (b)'s Gbps. It fails if a destination file
   differs from its source, a daemon reports an error, a runner that should
   work launches no K-AB or K-C (the destination's only in paranoid rounds),
   a runner that launched journals no ``phase.first_compile``, or
   ``verify_batched`` is not 24 of 24 in a paranoid round.
   Then the pump rounds (slice 9), at the daemon's default (paranoid
   verification off), on the same corpus and programs through two fresh
   daemons each: ``SKYPLANE_TPU_PUMP_PROCS=1``, ``2``, ``4``, then ``2`` with
   one sender worker SIGKILLed after a batch RPC was served and one receiver
   worker SIGKILLed. The destination's receiver and the source's sender run in
   that many spawned worker processes each, on the CPU; the sender workers'
   codec batches are RPCs served by the source daemon's runner on the card.
   The POST waits until every worker is up and has reported. Each round
   prints Gbps, wire reduction, REF share, NACKs and resends (a REF whose
   literal landed at a sibling receiver worker heals by NACK and a literal
   resend: logged, not a failure), ack lag, the batch RPCs served, the
   runner's K-AB and K-C launches and batch rows, the workers' CPU seconds,
   and the receiver workers' decode wall; then the rounds beside the witness
   round. A pump round fails if a file differs, a chunk failed, no batch RPC
   was served or the runner has fewer rows than RPCs served, the runner
   launched no K-AB or K-C, a batch RPC errored or a worker fell back to the
   host, a worker died (outside the kill round) or a pool is not whole, or a
   worker reports a CUDA context, jax or the JAX package loaded or a device
   other than the CPU; the kill round fails unless each daemon respawned a
   worker.
7. The client path (slice 10), what ``skyplane cp`` does between two sites:
   ``SkyplaneClient(...).pipeline(planning_algorithm="direct")`` with one
   ``CopyJob`` from the corpus written as 24 files of 8 MiB under a site-A
   root (``POSIXInterface`` tagged ``local:siteA``) to an empty site-B root
   (``local:siteB``), then ``pipe.start()``: the planner, the local
   provisioner spawning two port daemons as subprocesses on the device
   default (``cuda``), the read/write object-store operators, the tracker,
   deprovisioning. ``TransferConfig(compress="tpu", dedup=True,
   auto_codec_decision=False, encrypt_e2e=False, encrypt_socket_tls=False)``,
   the rest at its defaults (a whole 8 MiB object a chunk); the daemons
   inherit ``SKYPLANE_TPU_PARANOID_VERIFY=1`` so the destination's runner
   works too. A tracker hook reads, while the daemons still run, each
   daemon's device, program, ``phase.first_compile`` (``GET
   /api/v1/events``), compression profile, chunk states and the NVIDIA
   device files it holds open, and ``nvidia-smi``'s compute apps (in the
   card's sandbox every process there reads as one pid, so the check is
   per-pid device files plus the card's used memory rising). Prints the
   wall of ``pipe.start()`` split into plan, provision (daemon spawn to
   ready), transfer (dispatch and drain) and teardown, the planner's codec
   decisions and the tracker's ``transfer_stats``. It fails if a
   destination file differs, the tracker does not report every chunk
   complete, the destination reports a chunk not complete or a daemon an
   error, the source program's send op is not codec ``tpu`` with dedup, a
   daemon is not on ``cuda``, journaled no ``phase.first_compile`` or holds
   no card open, the card's used memory did not rise, or a daemon outlives
   deprovisioning. A failure prints each daemon's log.

8. The checkpoint blast (slice 11). (a) What ``skyplane-tpu blast`` does:
   ``SkyplaneClient(...).pipeline(planning_algorithm="blast")`` with one
   ``CopyJob`` from the corpus written as 24 files of 8 MiB under a site-A
   root to four empty roots tagged ``local:siteB`` to ``local:siteE``, codec
   ``tpu`` with dedup, plaintext, paranoid verification off (the daemon
   default); the local provisioner spawns five port daemons on the device
   default. The planner's relay tree (solver, source degree, fanout), the
   wall by stage, Gbps over the corpus times four sinks, each edge's egress
   bytes from ``skyplane_egress_bytes_total`` (and the source's over the
   corpus's raw bytes), each daemon's kernel launches (``GET
   /api/v1/profile/kernels``) and ``phase.first_compile``, and the card's
   used memory while the daemons run. It fails if a file at a sink differs,
   the tree was not solved by ``milp``, the source has more than one tree
   child, a daemon reports an error, is not on the device, holds no card
   open or outlives deprovisioning, or the source or an interior relay
   launched no K-AB or K-C. (b) A relay dies and the blast heals: five port
   daemons in process on the card on a greedy tree (source, relay, two more
   levels), the same corpus and codec, driven by ``BlastController``; the
   first relay is hard-killed once every chunk is registered there and some
   but not all are complete, and the controller starts a replacement,
   retargets the source's streams and re-drives what is missing. Launch
   counts zeroed just before the POST and read after convergence. Prints
   the kill time, the retargeted ops, the requeued chunks and the time from
   the kill to convergence. It fails unless every sink converges
   byte-identical with no duplicate chunk registration and the source's
   runner launched K-AB and K-C.
9. The always-on service (slice 11), what ``skyplane-tpu sync --watch`` and
   ``serve`` drive: a standing pair of port daemons in process on the card
   (phase 6's programs), and ``SkyplaneClient(...).service(wal, source_url,
   sink_url, chunk_bytes=8 MiB)`` attached to it. Three steps, launch counts
   zeroed before the first and read after the last: a ``sync`` job of the
   24-file corpus directory; a ``copy`` job of one corpus file whose
   controller is closed right after the submit while the fleet keeps
   pumping, then a fresh controller on the same WAL directory that must
   adopt it in ``recover()``; a ``sync_watch`` spec that spawns no round
   while nothing changed and one round after one file is overwritten with
   the next snapshot's bytes. Prints each job's start latency (submit to
   dispatched), Gbps, wire reduction, REF share, chunks posted and the
   source runner's K-AB and K-C launches, beside phase 7's provision time.
   It fails if a file differs, a job ends other than ``done``, recovery does
   not adopt the copy job or the sink registered one of its chunks other
   than once, the watch round ships chunks of an unchanged file, or the
   source's runner launched no K-AB or K-C.

10. The command line (slice 12), ``python -m skyplane_tpu_torch.cli.cli``
   subprocesses as a user runs them, each with a fresh
   ``SKYPLANE_TPU_CONFIG_ROOT`` and a time limit. (a) ``cp -r
   local:///<siteA>/ local:///<siteC>/ -y --compress tpu --dedup`` of the
   corpus written as 24 files of 8 MiB (the flags keep it from delegating to
   ``rsync``/``cp``), daemons on the device default, ``SKYPLANE_TPU_COLLECT=1``
   with a fleet log; both endpoints are ``local:local``, so the plan is
   same-region (read -> write, no send) and launches no kernel, as in the JAX
   package. A thread scans ``/proc`` for the daemons the CLI spawns. Prints
   the CLI's wall, its summary's Gbps (and wire reduction, absent with no
   send), the stage walls from ``timeline latest --fleet-dir --json`` and
   ``cloud ls`` of the destination. It fails unless the CLI exits 0, 24 of 24
   files are byte-identical, the summary is printed, each spawned daemon ran
   on the device and held the card open and is gone after the CLI exits, the
   fleet log holds the client stages and no ``phase.first_compile``, and
   ``cloud ls`` counts 24 objects. (b) ``serve --wal-dir W --spool S
   --source-url U1 --sink-url U2 --poll-s 0.05 --chunk-mb 8`` over phase 6's
   pair of port daemons in process on the card (their tracer sampling every
   chunk), launch counts zeroed just before and read just after: a ``copy``
   spec of the corpus directory dropped into the spool; ``sync <corpus>
   <mirror> --watch --interval 1 --spool S`` (round 0 ships the corpus); one
   file overwritten with the next snapshot's bytes (round 1 ships it). Then
   ``monitor --url U1 --url U2 --once``, ``tenants --url U1``, ``trace export
   --url U1 --url U2 -o t.json`` and ``bottleneck --trace t.json`` against the
   live daemons, and ``serve`` is sent SIGTERM. Prints each step's Gbps (start
   to ``status.json``), wire reduction and REF share, the job start latency,
   the source daemon's launches (``GET /api/v1/profile/kernels`` before and
   after) and each tool's first lines. It fails if a file differs,
   ``status.json`` shows other than three jobs done and the watch, or fewer
   than 2 watch rounds, the source launched no K-AB or K-C, a tool exits
   non-zero or prints no gateway, tenant, events or report, the trace holds
   spans of fewer than both gateways, or ``serve`` outlives SIGTERM by 30 s.

11. The multi-device data path (slice 13). Launch counts are zeroed just
   before its drive and read just after: (a)'s first step over each mesh,
   then (b). (a) ``make_spmd_datapath`` over meshes 1x1, 1x2, 2x2 and 2x4
   (data x seq) on phase 5's rows (B = 8 x 8 MiB, block 512, stride 64 KiB,
   mask bits 16), position i on ``cuda:(i % device_count)`` (on one card every
   position is ``cuda:0``: a logical mesh, its positions one after another).
   Each mesh's step launches K-A', K-E and K-D once a position (K-A' with a
   halo on every position past a row's first seq shard), its candidates,
   tags and fingerprints equal ``datapath_step``'s bit for bit, its n_lit sum
   to the step's, and every row's literals decode byte-identical shard by
   shard on the host; its time by CUDA events beside ``datapath_step``'s.
   K-A' with a halo equals its plain version on the 2x4 mesh's halo shards
   and on adversarial halos (a shard boundary inside a run of zeros and of
   0x5A, a candidate on a shard's first byte); its time beside its bound and
   beside K-A' without the halo, and the times of a position's slab copy and
   halo copy. (b) ``dryrun_multichip(4)`` with ``SKYPLANE_TPU_SPMD_CHECK=1``:
   the step at the reference's shapes, then 8 chunks of 8 MiB through
   ``DataPathProcessor`` (codec ``tpu``, dedup) over a meshed runner (2x2),
   wire bytes equal to the host path's and REF segments on the
   near-duplicate; K-AB and K-C launches per position. (c) A port daemon in
   process with ``SKYPLANE_TPU_SPMD=on`` builds its runner: unsharded on one
   card, a mesh over every card on 2^k >= 2 cards. Then the meshed runner's
   Gbps at 1, 2, 4 and 8 positions (``tools/spmd_scaling.py``), each point
   byte-identical to the host path first, a point whose positions repeat a
   card labelled as not scaling. (d) On 2 or more cards: a launch on the last
   card leaves the current device unchanged, and (a) and (b) again over
   distinct cards; elsewhere one line says why it did not run.

12. The cloud gateway path: port gateways booted from a wheel on
   sandbox VMs. A sandbox VM (``tests/torch_cloud_util.py`` ``SandboxVM``) is
   an ``SSHServer`` whose commands run in a local ``bash`` with ``sudo``,
   ``apt-get``, ``sysctl``, ``docker``, ``systemctl``, ``curl`` and
   ``shutdown`` shimmed, ``bootstrap.REMOTE_ROOT`` remapped under a temporary
   directory outside the checkout (also its cwd), and ``PYTHONPATH`` set to
   torch's site-packages and a ``boto3`` stand-in whose S3 buckets are
   directories (``SKYPLANE_FAKE_S3_ROOT``), not to the repo. (a) The port's
   wheel (only ``skyplane_tpu_torch/``, the kernels' sources as package data,
   no jax requirement), then ``start_gateway`` on VM A: venv with
   ``--system-site-packages``, ``pip install --no-deps`` of the wheel, the
   daemon from the venv's python with no ``SKYPLANE_GATEWAY_DEVICE``. Prints
   the wheel's bytes and seconds, the venv and install seconds; fails unless
   the daemon answers ``/status``, runs from the venv, is on the card (its
   ``GET /api/v1/profile/kernel_builds``) and holds it open, and a second
   ``start_gateway`` runs no pip install and restarts the daemon under the new
   gateway id. (b) ``SkyplaneClient(...).pipeline("direct")`` from
   ``s3://skyplane-tpu-src`` (``aws:us-east-1``) to ``s3://skyplane-tpu-dst``
   (``aws:us-west-2``): the corpus as 6 objects of 32 MiB, parts of 8 MiB
   (threshold 16 MiB), codec ``tpu`` with dedup, plaintext, paranoid
   verification on the VMs. The provisioner's ``aws`` provider is the port's
   ``AWSCloudProvider`` with ``provision_instance`` returning sandbox VMs (VM
   A again for us-east-1, a fresh VM B for us-west-2) and its global, region
   and firewall setup doing nothing, so ``SSHServer.start_gateway`` and
   ``bootstrap`` boot both gateways. Prints ``pipe.start()``'s wall by stage,
   Gbps over the transfer stage, each daemon's launches, where it built K-AB
   and K-C (path, source, seconds); fails unless every destination object is
   sha256-identical to its source and was completed as a 4-part multipart
   upload, VM A ran no pip install again, no daemon reports an error, each is
   on the card, the source launched K-AB and K-C and the destination K-C,
   each built under its VM's ``REMOTE_ROOT/build`` from the wheel's
   ``csrc`` in its venv, and no daemon outlives deprovisioning.

13. A multicast across three providers' gateways:
   ``SkyplaneClient(...).pipeline("direct")`` from ``cos://us-south/skyplane-tpu-src``
   (``cos:us-south``) to ``azure://skyplanetpu/skyplane-tpu-dst``
   (``azure:infer``) and ``scp://skyplane-tpu-dst`` (``scp:kr-west-1``) in one
   job: the corpus's first two snapshots as 3 objects of 32 MiB (phase 12's
   6 cut to 3 to keep the script inside its time limit), parts of 8 MiB,
   codec ``tpu`` with dedup, plaintext, paranoid verification on the VMs.
   The provisioner's providers are the port's ``IBMCloudProvider`` (asked
   for the COS region), ``AzureCloudProvider`` and ``SCPCloudProvider``, each
   returning a fresh sandbox VM that installs phase 12's wheel (not rebuilt),
   their global, region and firewall setup doing nothing. The VMs' path
   holds the ``ibm_boto3`` and ``azure.storage.blob`` stand-ins beside
   ``boto3`` (containers are directories; staged blocks wait for
   ``commit_block_list``); every endpoint they are given is on this host.
   Prints ``pipe.start()``'s wall by stage, Gbps over the transfer stage and
   per destination (to its daemon's last completion), each daemon's launches
   and where it built K-AB and K-C; fails unless every object at both
   destinations is sha256-identical to its source, every Azure object was
   committed from 4 blocks and every SCP object completed as a 4-part
   upload, no daemon reports an error, each is on the card, the source
   launched K-AB and K-C and each destination K-C, each built them under its
   VM's ``REMOTE_ROOT/build`` from the wheel's ``csrc``, each VM booted once
   from phase 12's wheel, and no daemon outlives deprovisioning.

14. The port's static analysis on the card's machine: ``python3 -m
   skyplane_tpu_torch.cli.cli lint skyplane_tpu_torch --json F`` as a
   subprocess from the checkout's root, with a fresh
   ``SKYPLANE_TPU_SKLINT_CACHE`` under ``build/``, run twice (cold, then
   warm). Prints the files checked, each run's process wall and pass wall
   beside the card's name and power limit, and the findings and
   suppressions by rule; fails unless both exit 0 with zero unsuppressed
   findings over more than 100 files, ``rule_counts`` lists every rule
   ``lint --list-rules`` prints, the cold run takes under 30 s, the warm run
   is a full cache hit with the same findings, and phase 12's wheel (not
   rebuilt) lists every ``skyplane_tpu_torch/analysis/*.py``. The JAX
   package's analysis is not run here.

The last lines are the card's ``nvidia-smi`` name and power limit, one JSON
line describing every kernel (``launches`` from phase 3 (b) and phase 5, and
for ``gear_mask_halo``, K-A' in halo mode, from phase 11; ``launches_cli``
from phase 10 (b); ``launches_spmd`` from phase 11's drive;
``launches_cloud`` from phase 12 (b), both daemons; ``launches_multicloud``
from phase 13, all three daemons), and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

CHUNK_MB = 8
N_SNAPSHOTS = 4
CHUNKS_PER_SNAPSHOT = 6
ZERO_FRAC = 0.25
BLOCK = 4096
WRITE_SITE_FRAC = 0.004
WRITE_RUN_BLOCKS = 8
WORKERS = 16
MAX_BATCH = 8
SEED = 0
# datapath_step's defaults (phase 5)
STEP_BLOCK = 512
STEP_FP_SEG = 1 << 16
STEP_MASK_BITS = 16
STEP_EXTRA_STRIDES = (4096, 1 << 17, 1 << 19, 64)
STEP_ODD_STRIDE = 1000  # not a multiple of 64: K-D's byte path, on the first 8192000 bytes of each row
# K-E's other block sizes, each on the step rows cut to a multiple of it: one
# byte, small blocks (a thread per run of blocks), a block that is not a power
# of two, and one larger than a tile (streamed twice)
STEP_EXTRA_BLOCKS = (1, 4, 16, 600, 4096, 40960)
SLICE1 = ("gear_compact", "segment_fp")
# phase 6's pump rounds, worker processes a daemon: 1 (one receiver worker,
# so no REF can miss its literal at a sibling shard; the restore out of the
# sender's process), 2 and 4
PUMP_PROCS = (1, 2, 4)
SLICE2 = ("gear_mask", "segment_fp_fixed", "blockpack_encode")

# the card's peak rates (NVIDIA H100 SXM): HBM bytes/s from the data sheet;
# the 32-bit integer instruction rate: the data sheet gives 67e12 float32
# FLOP/s (128 FP32 lanes per SM, a multiply-add counted as two), and a Hopper
# SM has 64 INT32 lanes, so it issues 67e12 / 2 / 2 integer instructions/s;
# and the dense int8 tensor-core rate, 1979e12 operations/s (a multiply-add
# counted as two). The kernels' CUDA-core work is counted as 32-bit integer
# instructions at the integer rate; the fingerprint kernels' u8 products
# (segment_fp, segment_fp_fixed) as tensor-core operations at the int8 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_INSTR_PER_S = 67e12 / 4
PEAK_INT8_TENSOR_OPS_PER_S = 1979e12
# the fingerprint kernels' work per 64-byte word: its u8 product with the
# [64, 32] word_limbs matrix (64 x 32 multiply-adds), and 18 integer
# instructions per word and lane counted from csrc/lane_poly.cuh: word_values
# joins and exchanges the limbs and folds (10: two shift-adds, three selects,
# a shuffle, four for the 2^16 weight and the fold), mul_lazy31 (4), the
# running u64 sum (2), the power read and the zero test (2)
WORD_TENSOR_OPS = 2 * 64 * 32
WORD_INT_INSTR = 18 * 8


def log(msg: str) -> None:
    print(msg, flush=True)


# ---- corpus: a copy of bench.py's snapshot-chain generator ----


def _clustered_mask(rng, n_blocks: int, site_frac: float, mean_run: int) -> np.ndarray:
    mask = np.zeros(n_blocks, bool)
    n_sites = max(1, int(n_blocks * site_frac))
    starts = rng.integers(0, n_blocks, n_sites)
    lengths = rng.geometric(1.0 / mean_run, n_sites)
    for s, l in zip(starts, lengths):
        mask[s : s + l] = True
    return mask


def _filesystem_content(rng, n_bytes: int) -> np.ndarray:
    """~35% text-like runs, ~25% structured records, the rest incompressible
    (the caller adds ~25% clustered zero extents)."""
    out = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    n_blocks = n_bytes // BLOCK
    text = _clustered_mask(rng, n_blocks, 0.35 / 24, 24)
    tmask = np.repeat(text, BLOCK)
    n_text = int(tmask.sum())
    if n_text:
        vocab = ((rng.integers(0, 256, (512, 8), dtype=np.uint8) & 0x3F) | 0x20).reshape(512, 8)
        toks = rng.integers(0, 512, n_text // 8 + 1)
        out[tmask] = vocab[toks].reshape(-1)[:n_text]
    rec = _clustered_mask(rng, n_blocks, 0.25 / 24, 24) & ~text
    run_id = np.cumsum(rec & ~np.concatenate([[False], rec[:-1]]))
    out2d = out.reshape(n_blocks, BLOCK)
    for rid in np.unique(run_id[rec]):
        blocks = np.flatnonzero(rec & (run_id == rid))
        record = rng.integers(0, 256, 64, dtype=np.uint8)
        span = np.tile(record, (len(blocks) * BLOCK) // 64)
        edits = rng.integers(0, len(span), max(1, len(span) // 32))
        span[edits] = rng.integers(0, 256, len(edits), dtype=np.uint8)
        out2d[blocks] = span.reshape(len(blocks), BLOCK)
    return out


def make_corpus(seed: int = SEED):
    """Snapshot chain: each snapshot is the previous one with clustered writes."""
    rng = np.random.default_rng(seed)
    chunk_bytes = CHUNK_MB << 20
    n_blocks = chunk_bytes // BLOCK
    snap = []
    for _ in range(CHUNKS_PER_SNAPSHOT):
        blocks = _filesystem_content(rng, chunk_bytes).reshape(n_blocks, BLOCK)
        blocks[_clustered_mask(rng, n_blocks, ZERO_FRAC / 16, 16)] = 0
        snap.append(blocks)
    chunks = [b.reshape(-1).tobytes() for b in snap]
    for _ in range(N_SNAPSHOTS - 1):
        nxt = []
        for b in snap:
            b2 = b.copy()
            mut = _clustered_mask(rng, n_blocks, WRITE_SITE_FRAC, WRITE_RUN_BLOCKS)
            b2[mut] = _filesystem_content(rng, int(mut.sum()) * BLOCK).reshape(-1, BLOCK)
            nxt.append(b2)
        chunks.extend(b.reshape(-1).tobytes() for b in nxt)
        snap = nxt
    return chunks


# ---- phase helpers ----


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events around the run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def traced_ms(fn, name: str, reps: int) -> str:
    """``reps`` calls of ``fn`` under torch.profiler: the device time per call
    of the kernels whose name holds ``name`` and of the memsets beside them,
    without the host's enqueue pace. Only the profiler's own failures read
    "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    except Exception as err:  # noqa: BLE001 — the profiler, not the port
        return f"not measured (profiler did not start: {err!r})"
    try:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    try:
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as err:  # noqa: BLE001 — the profiler, not the port
        return f"not measured (profiler events unreadable: {err!r})"
    kern = [e.time_range.elapsed_us() for e in events if name in e.name]
    memset = [e.time_range.elapsed_us() for e in events if "memset" in e.name.lower()]
    if not kern:
        return "not measured (no device events traced)"
    return (f"{sum(kern) / 1e3 / reps:.4f} ms of kernel time per call ({len(kern)} kernels over {reps} calls), "
            f"memset {sum(memset) / 1e3 / reps:.4f} ms per call")


def bound_ms(n_bytes: float, n_instr: float, n_tensor_ops: float = 0.0):
    """The least time for the work: the largest of the bytes at the HBM rate,
    the integer instructions at the INT32 rate and the u8 tensor-core
    operations at the int8 rate, and which of bytes or operations it is."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(n_instr / PEAK_INT_INSTR_PER_S, n_tensor_ops / PEAK_INT8_TENSOR_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def word_work(batch: torch.Tensor, n_split: int = 0):
    """(integer instructions, tensor-core operations) that the fingerprint
    kernels' word design needs for this batch: every word with a nonzero
    byte, and a second product for each of ``n_split`` words that an end
    cuts."""
    words = int((batch.view(-1, 64) != 0).any(1).sum().item()) + n_split
    return words * WORD_INT_INSTR, words * WORD_TENSOR_OPS


def power_rows_read(ends: np.ndarray, bucket: int, max_seg: int) -> int:
    """The 32-byte rows of word_powers that K-C reads for these ends: a
    segment ending at c reads rows (c % 64, m) for m below its length / 64."""
    c = np.minimum(np.maximum(ends.astype(np.int64), 0), bucket)
    start = np.concatenate([np.zeros((len(c), 1), np.int64), c[:, :-1]], 1)
    length = np.minimum(c - np.minimum(start, c), max_seg)
    need = np.zeros(64, np.int64)
    np.maximum.at(need, (c % 64).reshape(-1), -(-length // 64).reshape(-1))
    return int(need.sum())


def split_words(ends: np.ndarray, bucket: int) -> int:
    """Words that exactly one end cuts strictly inside (K-C's second product)."""
    n = 0
    for row in np.minimum(np.maximum(ends.astype(np.int64), 0), bucket):
        inside = row[(row % 64 != 0) & (row < bucket)]
        _, counts = np.unique(inside // 64, return_counts=True)
        n += int((counts == 1).sum())
    return n


def adversarial_ends_rows(bucket: int, n_slots: int, rng):
    """K-C's adversarial rows at the main path's shapes: ends at every residue
    mod 64 (with two ends 1 byte apart and ends at 64k - 1, 64k, 64k + 1), a
    row of 0xFF bytes, a random row with one segment of 2^19 bytes (past the
    power table: clamped), and a random row whose only end is the bucket."""
    rows = rng.integers(0, 256, (4, bucket), dtype=np.uint8)
    rows[1] = 0xFF
    ends = np.full((4, n_slots), bucket, np.int32)
    e = sorted({(1 << 16) * (k + 1) + 64 * k + k for k in range(64)}
               | {5000, 5001, 8191, 8192, 8193, 3 << 20, (3 << 20) + 1, (3 << 20) + 2})
    ends[0, : len(e)] = e
    e1 = np.cumsum(rng.integers(64, 1 << 15, 800))
    e1 = np.unique(e1[e1 < bucket])
    ends[1, : len(e1)] = e1
    ends[2, :3] = [4097, 4097 + (1 << 19), 4097 + (1 << 19) + 63]
    return rows, ends


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return int((got.long() - want.long()).abs().max().item())


def ends_slots_for(packed: np.ndarray, lens, bucket: int, params, cap: int, n_slots: int) -> np.ndarray:
    from skyplane_tpu_torch.ops.cdc import select_boundaries

    ends = np.full((len(lens), n_slots), bucket, np.int32)
    for i, n in enumerate(lens):
        e = select_boundaries(packed[i, : packed[i, cap]].astype(np.int64), int(n), params)
        ends[i, : len(e)] = e
        if n < bucket:
            ends[i, len(e)] = bucket
    return ends


def check_kernels(dev, chunks, params):
    """Phase 2: every kernel == its plain version at the main path's shapes."""
    from skyplane_tpu_torch.ops import kernels
    from skyplane_tpu_torch.ops.fingerprint import N_LANES
    from skyplane_tpu_torch.ops.fused_cdc import candidate_cap, slots_cap
    from skyplane_tpu_torch.state import device_tables

    tables = device_tables(dev)
    bucket = CHUNK_MB << 20
    cap, n_slots = candidate_cap(bucket, params), slots_cap(bucket, params)
    rng = np.random.default_rng(1)
    rows = np.stack([np.frombuffer(c, np.uint8) for c in chunks[:MAX_BATCH]])  # corpus rows
    rows[5] = 0  # all-zero row (a batch pad row, n = 0)
    short = bucket * 3 // 8 + 17
    rows[6, short:] = 0  # short row: a garbage end covers its zero padding
    rows[7] = rng.integers(0, 256, bucket, dtype=np.uint8)
    lens = [bucket] * MAX_BATCH
    lens[5], lens[6] = 0, short
    batch = torch.from_numpy(rows).to(dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    errs = {}

    packed = kernels.gear_compact(batch, lens_t, tables, params.mask_bits, cap)
    errs["gear_compact"] = max_abs_err(packed, kernels.gear_compact_plain(batch, lens_t, tables, params.mask_bits, cap))
    over = kernels.gear_compact(batch, lens_t, tables, params.mask_bits, 16)  # every full row overflows a cap of 16
    errs["gear_compact"] = max(errs["gear_compact"], max_abs_err(over, kernels.gear_compact_plain(batch, lens_t, tables, params.mask_bits, 16)))
    dense = kernels.gear_compact(batch, lens_t, tables, 4, cap)  # mask_bits 4: the cap is hit mid-chunk
    errs["gear_compact"] = max(errs["gear_compact"], max_abs_err(dense, kernels.gear_compact_plain(batch, lens_t, tables, 4, cap)))
    repeats = sum(max_abs_err(kernels.gear_compact(batch, lens_t, tables, params.mask_bits, cap), packed) for _ in range(20))
    errs["gear_compact"] = max(errs["gear_compact"], repeats)  # chunks run in another order each launch
    packed_np = packed.cpu().numpy()
    n_over = int((over.cpu().numpy()[:, 16] > 16).sum())
    if n_over < 5:
        raise AssertionError(f"a cap of 16 should overflow the full rows: {over.cpu().numpy()[:, 16].tolist()}")
    n_dense = dense.cpu().numpy()[:, cap]
    if (n_dense > cap).sum() < 5:
        raise AssertionError(f"mask_bits 4 should overflow the cap on the full rows: {n_dense.tolist()}")
    del over, dense

    ends = torch.from_numpy(ends_slots_for(packed_np, lens, bucket, params, cap, n_slots)).to(dev)
    n_real = int((ends.cpu().numpy() < bucket).sum())
    lanes = kernels.segment_fp(batch, ends, tables)
    errs["segment_fp"] = max_abs_err(lanes, kernels.segment_fp_plain(batch, ends, tables))
    adv_rows, adv_ends = adversarial_ends_rows(bucket, n_slots, rng)
    adv_b, adv_e = torch.from_numpy(adv_rows).to(dev), torch.from_numpy(adv_ends).to(dev)
    adv_err = max_abs_err(kernels.segment_fp(adv_b, adv_e, tables), kernels.segment_fp_plain(adv_b, adv_e, tables))
    errs["segment_fp"] = max(errs["segment_fp"], adv_err)
    del adv_b, adv_e
    torch.cuda.empty_cache()
    sync(dev)
    log(f"phase 2: B={MAX_BATCH} bucket={bucket} cap={cap} n_slots={n_slots}: "
        f"candidates per row {packed_np[:, cap].tolist()}, rows over a cap of 16: {n_over}, at mask_bits 4 {n_dense.tolist()}, "
        f"real segment ends {n_real} of {MAX_BATCH * n_slots} slots, max |kernel - plain| {errs} (gear_compact also at a cap "
        f"of 16, at mask_bits 4 and over 20 repeated launches); segment_fp on the adversarial rows (end residues mod 64, "
        f"0xFF, a 2^19 segment, the bucket as the only end): {adv_err}")
    if any(errs.values()):
        raise AssertionError(f"kernel disagrees with its plain version: {errs}")

    # timing at the same shapes; the plain versions are the same arithmetic, no yardstick of speed
    t = {
        "gear_compact": (
            time_ms(lambda: kernels.gear_compact(batch, lens_t, tables, params.mask_bits, cap), 200),
            time_ms(lambda: kernels.gear_compact_plain(batch, lens_t, tables, params.mask_bits, cap), 3, 1),
        ),
        "segment_fp": (
            time_ms(lambda: kernels.segment_fp(batch, ends, tables), 50),
            time_ms(lambda: kernels.segment_fp_plain(batch, ends, tables), 3, 1),
        ),
    }
    traced = traced_ms(lambda: kernels.gear_compact(batch, lens_t, tables, params.mask_bits, cap), "gear_compact", 200)
    # bounds from this run's inputs: each input read once, each output written once
    n_in = MAX_BATCH * bucket
    ends_np = ends.cpu().numpy()
    bounds = {
        # read bytes + lens + table; write [B, cap+1] i32 and 16 bytes of
        # status per chunk. Per byte: the hash step (one shift-add), the
        # top-bits test, the length test and the bit set
        "gear_compact": bound_ms(
            n_in + 4 * MAX_BATCH + 1024 + 4 * packed.numel() + 16 * MAX_BATCH * -(-bucket // kernels.GEAR_CHUNK),
            4 * n_in,
        ),
        # read bytes, ends, word_limbs and the word_powers rows the segments
        # index; write the lanes. Per word with a nonzero byte (twice for a
        # word an end cuts): its u8 product and 18 integer instructions a lane
        "segment_fp": bound_ms(
            n_in + 4 * ends.numel() + 64 * 32 + 32 * power_rows_read(ends_np, bucket, kernels.MAX_SEGMENT_BYTES)
            + 4 * lanes.numel(),
            *word_work(batch, split_words(ends_np, bucket)),
        ),
    }
    for name, (ms, plain_ms) in t.items():
        b, by = bounds[name]
        log(f"  {name}: {ms:.4f} ms/launch (plain {plain_ms:.3f} ms), bound {b:.4f} ms ({by}), {b / ms:.1%} of bound")
    read_ms = time_ms(lambda: batch.view(torch.int32).max(), 100)  # a yardstick for K-AB's reads, not its function
    log(f"  gear_compact traced: {traced}; a PyTorch reduction reading the same {n_in} bytes (int32 max): {read_ms:.4f} ms")
    return errs, t, bounds


class HostSplit:
    """Host time of the sender path by part, from wrappers installed around
    the package's functions for one pass (nothing is counted inside the
    package): per-thread CPU time (``time.thread_time_ns``) and wall time
    (``perf_counter_ns``), summed over the sender threads. A call nested in
    another of its own part counts once."""

    PARTS = ("codec", "recipe_with_codec", "select_boundaries", "staging", "blake2b", "leader_batch")

    def __init__(self):
        self.cpu_ns = dict.fromkeys(self.PARTS, 0)
        self.wall_ns = dict.fromkeys(self.PARTS, 0)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._undo = []

    def wrap(self, part: str, fn):
        def timed(*args, **kwargs):
            active = self._tls.__dict__.setdefault("active", set())
            if part in active:
                return fn(*args, **kwargs)
            active.add(part)
            c0, w0 = time.thread_time_ns(), time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                dc, dw = time.thread_time_ns() - c0, time.perf_counter_ns() - w0
                active.discard(part)
                with self._lock:
                    self.cpu_ns[part] += dc
                    self.wall_ns[part] += dw

        return timed

    def _patch(self, owner, name: str, part: str, static: bool = False) -> None:
        import inspect

        orig = inspect.getattr_static(owner, name)
        fn = orig.__func__ if static else orig
        setattr(owner, name, staticmethod(self.wrap(part, fn)) if static else self.wrap(part, fn))
        self._undo.append((owner, name, orig))

    def install(self, proc) -> None:
        from skyplane_tpu_torch.ops import batch_runner, fused_cdc, pipeline

        proc.codec = proc.codec._replace(encode=self.wrap("codec", proc.codec.encode))
        self._patch(pipeline, "build_recipe", "recipe_with_codec")
        self._patch(fused_cdc, "select_boundaries", "select_boundaries")
        self._patch(fused_cdc.FusedCDCFP, "stage", "staging")
        self._patch(fused_cdc.FusedCDCFP, "_upload", "staging")
        self._patch(fused_cdc, "digests_from_lanes", "blake2b")
        self._patch(pipeline.DataPathProcessor, "_chunk_fingerprint", "blake2b", static=True)
        self._patch(batch_runner.DeviceBatchRunner, "_run_batch", "leader_batch")

    def uninstall(self) -> None:
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo = []

    def summary(self, device_wait_ns: int) -> str:
        cpu = dict(self.cpu_ns)
        wall = dict(self.wall_ns)
        cpu["recipe"] = cpu.pop("recipe_with_codec") - cpu["codec"]
        wall["recipe"] = wall.pop("recipe_with_codec") - wall["codec"]
        parts = ("codec", "recipe", "select_boundaries", "staging", "blake2b", "leader_batch")
        return ("host split, CPU ms / wall ms summed over threads: " + ", ".join(
            f"{k} {cpu[k] / 1e6:.1f} / {wall[k] / 1e6:.1f}" for k in parts) + f", device wait (wall) {device_wait_ns / 1e6:.1f} "
            "(leader_batch: the leaders' batch runs, call A to call B's readback, selection and staging of the batch inside)")


def thread_clock_step_ns(samples: int = 5) -> int:
    """The smallest step of the per-thread CPU clock seen while spinning: the
    resolution of the CPU ms of the host split on this machine."""
    steps = []
    for _ in range(samples):
        t0 = time.thread_time_ns()
        deadline = time.perf_counter() + 0.2
        t1 = t0
        while t1 == t0 and time.perf_counter() < deadline:
            t1 = time.thread_time_ns()
        steps.append(t1 - t0)
    return min(steps)


def sender_pass(dev, runner, chunks, params, codec: str, native_on: bool, label: str, card: str) -> dict:
    """One timed pass of the sender path over the corpus (16 threads, fresh
    index, fingerprints committed per chunk) with the host split, launch
    counts zeroed just before and read just after."""
    from skyplane_tpu_torch.native import datapath as native_dp
    from skyplane_tpu_torch.ops import kernels
    from skyplane_tpu_torch.ops.dedup import SenderDedupIndex
    from skyplane_tpu_torch.ops.pipeline import DataPathProcessor

    native_dp._available = native_on
    proc = DataPathProcessor(codec_name=codec, dedup=True, cdc_params=params, batch_runner=runner, device=dev)
    index = SenderDedupIndex()
    done_order, payloads = [], {}
    order_lock = threading.Lock()

    def one(i: int) -> None:
        p = proc.process(chunks[i], index)
        with order_lock:  # delivered -> commit (sender contract), in delivery order
            for fp, size in p.new_fingerprints:
                index.add(fp, size)
            payloads[i] = p
            done_order.append(i)

    raw_total = sum(len(c) for c in chunks)
    split = HostSplit()
    split.install(proc)
    overflow0 = runner.fused.overflow_rows
    pre = runner.counters()
    try:
        sync(dev)
        kernels.reset_launch_counts()
        cpu0, t0 = time.process_time(), time.perf_counter()
        with ThreadPoolExecutor(max_workers=WORKERS) as pool:
            list(pool.map(one, range(len(chunks))))
        sync(dev)
        dt, cpu_s = time.perf_counter() - t0, time.process_time() - cpu0
        launches = kernels.launch_counts()
    finally:
        split.uninstall()
    post = runner.counters()
    wire_total = sum(len(p.wire_bytes) for p in payloads.values())
    n_seg = sum(p.n_segments for p in payloads.values())
    n_ref = sum(p.n_ref_segments for p in payloads.values())
    gbps = raw_total * 8 / dt / 1e9
    log(f"phase 3 ({label}) on {card}: codec {codec}, native library {'on' if native_on else 'off'}: {len(chunks)} chunks / "
        f"{raw_total} bytes in {dt:.3f} s = {gbps:.3f} Gbps effective; process CPU {cpu_s:.3f} s ({cpu_s / dt:.2f} cores); "
        f"wire reduction {raw_total / wire_total:.3f}x ({wire_total} wire bytes); REF segments {n_ref} of {n_seg}; "
        f"overflow rows {runner.fused.overflow_rows - overflow0}; batch windows {post['batch_windows'] - pre['batch_windows']}, "
        f"padded rows {post['batch_padded_rows'] - pre['batch_padded_rows']}; kernel launches {launches}")
    log(f"phase 3 ({label}): " + split.summary(proc.stats.as_dict()["device_wait_ns"]))
    if any(launches[k] == 0 for k in SLICE1):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if n_ref == 0:
        raise AssertionError("no REF segments on a snapshot chain")
    return dict(launches=launches, payloads=payloads, done_order=done_order, gbps=gbps)


def check_sample(dev, runner, chunks, params, codec_name: str) -> None:
    """Sampled wire bytes: the device path's equal the host path's with the
    native library on and with it off (fresh indexes, one chunk at a time)."""
    from skyplane_tpu_torch.entry import host_wire
    from skyplane_tpu_torch.native import datapath as native_dp
    from skyplane_tpu_torch.ops.codecs import get_codec
    from skyplane_tpu_torch.ops.dedup import SenderDedupIndex
    from skyplane_tpu_torch.ops.pipeline import DataPathProcessor

    codec = get_codec(codec_name)
    sample = [0, 1, 2, 3, 4, 5, 6, 12]  # 6 and 12 are later snapshots of chunk 0
    native_dp._available = True
    seq = DataPathProcessor(codec_name=codec_name, dedup=True, cdc_params=params, batch_runner=runner, device=dev)
    indexes = [SenderDedupIndex() for _ in range(3)]
    sample_refs = 0
    t_on = t_off = 0.0
    for i in sample:
        native_dp._available = True
        p = seq.process(chunks[i], indexes[0])
        t0 = time.perf_counter()
        on = host_wire(chunks[i], indexes[1], codec, params)
        t1 = time.perf_counter()
        native_dp._available = False
        off = host_wire(chunks[i], indexes[2], codec, params)
        t_on, t_off = t_on + t1 - t0, t_off + time.perf_counter() - t1
        native_dp._available = True
        if not (p.wire_bytes == on[0] == off[0]) or not (p.n_ref_segments == on[1] == off[1]):
            raise AssertionError(f"chunk {i}, codec {codec_name}: wire bytes differ between the device path and the host path")
        sample_refs += on[1]
        for index, new in zip(indexes, (p.new_fingerprints, on[2], off[2])):
            for fp, size in new:
                index.add(fp, size)
    if sample_refs == 0:
        raise AssertionError("the sampled near-duplicates carried no REF segment")
    log(f"phase 3: codec {codec_name}: wire bytes of chunks {sample} equal across the device path and the host path "
        f"with the native library on and off ({sample_refs} REF segments); host path {t_on:.3f} s on, {t_off:.3f} s off")


def check_restore(dev, chunks, params, result: dict, native_on: bool, label: str) -> None:
    """Every chunk of a pass restores byte-identical under paranoid verify,
    in delivery order; the receiver's literal check runs natively when the
    library is on."""
    from skyplane_tpu_torch.chunk import ChunkFlags, WireProtocolHeader
    from skyplane_tpu_torch.native import datapath as native_dp
    from skyplane_tpu_torch.ops.dedup import SegmentStore
    from skyplane_tpu_torch.ops.pipeline import DataPathProcessor

    native_dp._available = native_on
    receiver = DataPathProcessor(codec_name="none", dedup=True, cdc_params=params, paranoid_verify=True, device=dev)
    store = SegmentStore()
    t0 = time.perf_counter()
    for i in result["done_order"]:
        p = result["payloads"][i]
        header = WireProtocolHeader(
            chunk_id=uuid.uuid4().hex, data_len=len(p.wire_bytes), raw_data_len=p.raw_len, codec=int(p.codec),
            flags=int(ChunkFlags.RECIPE) if p.is_recipe else 0, fingerprint=p.fingerprint,
        )
        got = receiver.restore(p.wire_bytes, header, store, ref_wait_timeout=5.0)
        if hashlib.blake2b(got, digest_size=16).digest() != hashlib.blake2b(chunks[i], digest_size=16).digest():
            raise AssertionError(f"pass {label}: chunk {i} did not restore byte-identical")
    dt = time.perf_counter() - t0
    native_dp._available = True
    log(f"phase 3 ({label}): all {len(result['done_order'])} chunks restored byte-identical (paranoid re-fingerprint on "
        f"the card), native library {'on' if native_on else 'off'}: {dt:.3f} s; verify_counters {receiver.verify_counters()}")


def main_path(dev, chunks, params, card: str, with_lz4: bool) -> dict:
    """Phase 3: the sender path over the corpus in passes (a) codec tpu with
    the native library off, (b) tpu with it on (the main path), (c)
    native_lz, (d) lz4 when liblz4 is present; two rounds in turns (a b c d,
    then d c b a). Then the checks. Returns the kernel launches of pass (b)'s
    first run and pass (b)'s Gbps in both rounds."""
    from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner
    from skyplane_tpu_torch.ops.dedup import SenderDedupIndex
    from skyplane_tpu_torch.ops.pipeline import DataPathProcessor

    runner = DeviceBatchRunner(cdc_params=params, max_batch=MAX_BATCH, device=dev)
    warm = DataPathProcessor(codec_name="tpu", dedup=True, cdc_params=params, batch_runner=runner, device=dev)
    warm_rng = np.random.default_rng(99)
    warm_chunks = [warm_rng.integers(0, 256, CHUNK_MB << 20, dtype=np.uint8).tobytes() for _ in range(MAX_BATCH)]
    with ThreadPoolExecutor(max_workers=WORKERS) as pool:
        list(pool.map(lambda c: warm.process(c, SenderDedupIndex()), warm_chunks))

    log(f"phase 3: the per-thread CPU clock steps by {thread_clock_step_ns() / 1e6:.3f} ms on this machine "
        "(the host split's CPU ms are sums of whole steps)")
    passes = {"a": ("tpu", False), "b": ("tpu", True), "c": ("native_lz", True)}
    if with_lz4:
        passes["d"] = ("lz4", True)
    else:
        log("phase 3: pass (d), codec lz4: not measured (liblz4.so.1 is not present on this machine)")
    first, gbps = {}, {k: [] for k in passes}
    for label in list(passes) + list(reversed(passes)):
        codec, native_on = passes[label]
        r = sender_pass(dev, runner, chunks, params, codec, native_on, label, card)
        gbps[label].append(r["gbps"])
        if label not in first:
            first[label] = r
            check_restore(dev, chunks, params, r, native_on, label)
    log(f"phase 3 on {card}: Gbps by pass over two rounds: " + "; ".join(
        f"({k}) {passes[k][0]}, native {'on' if passes[k][1] else 'off'}: " + ", ".join(f"{g:.3f}" for g in v)
        for k, v in gbps.items()))
    for codec in ("tpu", "native_lz"):
        check_sample(dev, runner, chunks, params, codec)
    return first["b"]["launches"], gbps["b"]


class GatewaySplit(HostSplit):
    """Host time of phase 6 by stage, summed over every thread of both
    gateways (same wrappers as HostSplit): the source's file reads, the
    sender's framing (the staged chunk read and the data path) and its data
    path alone, the receiver's socket reads, whole decode tasks and, inside
    them, the recipe assembly (literal blob decode, literal fingerprints,
    segment store), the paranoid re-fingerprint and the landing write; the
    destination's wait-receiver polls (20 ms sleeps included) and file
    writes."""

    PARTS = ("read_local", "frame", "sender_datapath", "recv", "decode", "recipe_restore", "paranoid_verify", "land",
             "wait_receiver", "write_local")

    def install(self, proc=None) -> None:
        from skyplane_tpu_torch.gateway.operators import gateway_operator as op
        from skyplane_tpu_torch.gateway.operators import gateway_receiver as rx
        from skyplane_tpu_torch.ops import pipeline

        self._patch(op.GatewayReadLocalOperator, "process", "read_local")
        self._patch(op.GatewaySenderOperator, "_frame_chunk", "frame")
        self._patch(pipeline.DataPathProcessor, "process", "sender_datapath")
        self._patch(rx.GatewayReceiver, "_recv_exact", "recv")
        self._patch(rx.GatewayReceiver, "_process_task", "decode")
        self._patch(pipeline, "parse_recipe", "recipe_restore")
        self._patch(pipeline.DataPathProcessor, "_cdc_and_fps", "paranoid_verify")
        self._patch(rx.GatewayReceiver, "_land", "land", static=True)
        self._patch(op.GatewayWaitReceiverOperator, "process", "wait_receiver")
        self._patch(op.GatewayWriteLocalOperator, "process", "write_local")

    def summary(self, device_wait_ns: int = 0) -> str:
        return "host split by stage, CPU ms / wall ms summed over threads: " + ", ".join(
            f"{k} {self.cpu_ns[k] / 1e6:.1f} / {self.wall_ns[k] / 1e6:.1f}" for k in self.PARTS)


GATEWAY_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_gateway"  # gitignored, inside the checkout
FIRST_COMPILE = "phase.first_compile"


class Node:
    """One port gateway daemon in this process on a thread, with the
    ``get``/``post``/``control_port`` surface ``BlastController`` polls (the
    handle ``tests/integration/harness.py`` gives it)."""

    def __init__(self, daemon, thread):
        from skyplane_tpu_torch.gateway.control_auth import control_session

        self.daemon, self.thread, self.session = daemon, thread, control_session()

    @property
    def control_port(self) -> int:
        return self.daemon.api.port

    def url(self, route: str) -> str:
        return f"http://127.0.0.1:{self.control_port}/api/v1/{route}"

    def get(self, route: str, **kw):
        return self.session.get(self.url(route), **kw)

    def post(self, route: str, **kw):
        return self.session.post(self.url(route), **kw)

    def stop(self) -> None:
        self.daemon.stop()
        self.thread.join(timeout=30)
        if self.thread.is_alive():
            raise AssertionError(f"daemon {self.daemon.gateway_id} did not stop")


def start_daemon(dev, params, root: Path, gateway_id: str, op: dict, info: dict, pump_procs: int = 0) -> Node:
    """Start a ``GatewayDaemon`` on ``dev`` running the one root operator
    ``op`` (control port 0 on 127.0.0.1, plaintext control and data, its own
    ``DeviceBatchRunner``; a CPU daemon builds none, so a rehearsal on the CPU
    hands it one) and wait until its ``/status`` answers."""
    from skyplane_tpu_torch.gateway.gateway_daemon import GatewayDaemon
    from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner

    runner = (DeviceBatchRunner(cdc_params=params, max_batch=MAX_BATCH, device=dev, gateway_id=gateway_id)
              if dev.type == "cpu" else None)
    saved = os.environ.get("SKYPLANE_TPU_PUMP_PROCS")
    os.environ["SKYPLANE_TPU_PUMP_PROCS"] = str(pump_procs)  # read once, by the daemon's constructor
    try:
        daemon = GatewayDaemon(
            "local:local", str(root / gateway_id), {"plan": [{"partitions": ["default"], "value": [op]}]}, info,
            gateway_id, control_port=0, bind_host="127.0.0.1", use_tls=False, cdc_params=params, device=dev,
            batch_runner=runner,
        )
    finally:
        if saved is None:
            os.environ.pop("SKYPLANE_TPU_PUMP_PROCS", None)
        else:
            os.environ["SKYPLANE_TPU_PUMP_PROCS"] = saved
    if daemon.batch_runner is None:
        raise AssertionError(f"daemon {gateway_id} on {dev} built no batch runner")
    thread = threading.Thread(target=daemon.run, name=f"daemon-{gateway_id}", daemon=True)
    thread.start()
    node = Node(daemon, thread)
    deadline = time.monotonic() + 30
    while True:
        try:
            node.get("status", timeout=30).raise_for_status()
            return node
        except Exception:  # noqa: BLE001 — the control API is not up yet
            if time.monotonic() > deadline:
                raise
            time.sleep(0.02)


class DaemonPair:
    """Phase 6's two port gateway daemons, in process on threads as
    ``tests/integration/harness.py`` starts them (control port 0 on
    127.0.0.1, plaintext control and data, each building its own
    ``DeviceBatchRunner`` on ``dev``): the source runs ``read_local`` (8) ->
    ``send`` (16 connections, codec ``tpu``, dedup, window 16) and the
    destination ``receive`` (dedup) -> ``write_local``. Driven through the
    control API with the port's standard-library client."""

    def __init__(self, dev, params, root: Path, pump_procs: int = 0):
        from skyplane_tpu_torch.gateway.control_auth import control_session

        self.session = control_session()
        self.pump_procs = pump_procs
        recv = {"op_type": "receive", "handle": "recv", "dedup": True,
                "children": [{"op_type": "write_local", "handle": "write", "children": []}]}
        self.dst = self._start(dev, params, root, "gw_dst", recv, {})
        send = {"op_type": "send", "handle": "send", "target_gateway_id": "gw_dst", "region": "local:local",
                "num_connections": WORKERS, "compress": "tpu", "dedup": True, "encrypt": False, "window": 16,
                "children": []}
        read = {"op_type": "read_local", "handle": "read", "num_connections": 8, "children": [send]}
        info = {"gw_dst": {"public_ip": "127.0.0.1", "control_port": self.dst[0].api.port}}
        self.src = self._start(dev, params, root, "gw_src", read, info)

    def _start(self, dev, params, root: Path, gateway_id: str, op: dict, info: dict):
        node = start_daemon(dev, params, root, gateway_id, op, info, self.pump_procs)
        return node.daemon, node.thread

    def url(self, daemon, route: str) -> str:
        return f"http://127.0.0.1:{daemon.api.port}/api/v1/{route}"

    def get(self, daemon, route: str, **kw):
        resp = self.session.get(self.url(daemon, route), timeout=30, **kw)
        resp.raise_for_status()
        return resp.json()

    def dispatch(self, reqs) -> None:
        self.session.post(self.url(self.src[0], "chunk_requests"), json=[r.as_dict() for r in reqs], timeout=60).raise_for_status()

    def wait_complete(self, ids, timeout: float) -> None:
        """Poll the destination's ``/chunk_status_log`` every 10 ms until every
        id is complete; raise on an error at either daemon or the timeout."""
        pending, deadline, n = set(ids), time.monotonic() + timeout, 0
        while pending:
            status = self.get(self.dst[0], "chunk_status_log", params={"chunk_ids": ",".join(sorted(pending))})["chunk_status"]
            pending = {c for c in pending if status.get(c) != "complete"}
            n += 1
            if pending and n % 20 == 0:
                for daemon, _ in (self.src, self.dst):
                    errs = self.get(daemon, "errors")["errors"]
                    if errs:
                        raise AssertionError(f"phase 6: daemon {daemon.gateway_id} failed: {errs[0][:2000]}")
            if pending and time.monotonic() > deadline:
                raise AssertionError(f"phase 6: {len(pending)} of {len(ids)} chunks incomplete after {timeout:.0f} s")
            if pending:
                time.sleep(0.01)

    def first_compile(self, daemon, since: int):
        """The daemon runner's ``phase.first_compile`` interval in seconds from
        ``GET /api/v1/events`` (None when it journaled none)."""
        events = self.get(daemon, "events", params={"since": since})["events"]
        edges = {e["edge"]: e for e in events if e["kind"] == FIRST_COMPILE and e.get("gateway") == daemon.gateway_id}
        if set(edges) != {"start", "end"}:
            return None
        return edges["end"]["mono"] - edges["start"]["mono"], edges["start"]["bucket"], edges["start"]["rows"]

    def stop(self) -> None:
        for daemon, _ in (self.src, self.dst):
            daemon.stop()
        for daemon, thread in (self.src, self.dst):
            thread.join(timeout=30)
            if thread.is_alive():
                raise AssertionError(f"phase 6: daemon {daemon.gateway_id} did not stop")


def gateway_round(dev, files, chunks, params, card: str, label: str, paranoid: bool, trace: bool = False) -> dict:
    """One round of phase 6 through two fresh port daemons (fresh runners and
    index): POST the 24 chunk requests to the source, wait until the
    destination reports all 24 complete, check each file against its source.
    ``paranoid`` sets ``SKYPLANE_TPU_PARANOID_VERIFY=1`` for the daemons (off
    is the daemon's default: the witness round). Returns the round's numbers."""
    from skyplane_tpu_torch.chunk import Chunk, ChunkRequest
    from skyplane_tpu_torch.obs import get_recorder

    for _, dest in files:
        dest.unlink(missing_ok=True)
    saved = os.environ.pop("SKYPLANE_TPU_PARANOID_VERIFY", None)
    if paranoid:
        os.environ["SKYPLANE_TPU_PARANOID_VERIFY"] = "1"
    try:
        since = get_recorder().seq()
        pair = DaemonPair(dev, params, GATEWAY_DIR / f"round_{label}")
    finally:
        os.environ.pop("SKYPLANE_TPU_PARANOID_VERIFY", None)
        if saved is not None:
            os.environ["SKYPLANE_TPU_PARANOID_VERIFY"] = saved
    src, dst = pair.src[0], pair.dst[0]
    reqs = [
        ChunkRequest(chunk=Chunk(src_key=str(s), dest_key=str(d), chunk_id=uuid.uuid4().hex,
                                 chunk_length_bytes=len(c), file_offset_bytes=0),
                     src_region="local:local", dst_region="local:local", src_type="local", dst_type="local")
        for (s, d), c in zip(files, chunks)
    ]
    split = None if trace else GatewaySplit()
    if split is not None:
        split.install()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    try:
        cpu0, t0 = time.process_time(), time.perf_counter()
        pair.dispatch(reqs)
        pair.wait_complete([r.chunk.chunk_id for r in reqs], timeout=300.0)
        dt, cpu_s = time.perf_counter() - t0, time.process_time() - cpu0
        for i, ((_, dest), c) in enumerate(zip(files, chunks)):
            if hashlib.blake2b(dest.read_bytes(), digest_size=16).digest() != hashlib.blake2b(c, digest_size=16).digest():
                raise AssertionError(f"phase 6 ({label}): destination file {i} differs from its source")
        sender = next(op for op in src.operators if type(op).__name__ == "GatewaySenderOperator")
        stats = sender.datapath_counters()
        wire = sender.wire_counters()
        decode = dst.receiver.decode_counters()
        verify = dst.receiver.processor.verify_counters()
        compiles = {d.gateway_id: pair.first_compile(d, since) for d in (src, dst)}
    finally:
        if prof is not None:
            sync(dev)
            prof.stop()
        if split is not None:
            split.uninstall()
        pair.stop()
    raw_total = sum(len(c) for c in chunks)
    gbps = raw_total * 8 / dt / 1e9
    launches = {d.gateway_id: d.batch_runner.fused.launch_counts() for d in (src, dst)}
    ref_share = stats["ref_segments"] / stats["segments"] if stats["segments"] else 0.0
    log(f"phase 6 ({label}, paranoid verify {'on' if paranoid else 'off: the daemon default'}) on {card}: two port "
        f"daemons, {len(reqs)} of {len(reqs)} files written byte-identical, {raw_total} bytes in {dt:.3f} s = "
        f"{gbps:.3f} Gbps from the POST to the last completion; wire bytes {stats['wire_bytes']}, wire reduction "
        f"{raw_total / stats['wire_bytes']:.3f}x, REF segments {stats['ref_segments']} of {stats['segments']} "
        f"({ref_share:.2%}); NACKs {wire['nacks_reaped']}, resends {wire['frames_sent'] - len(reqs)}, stream resets "
        f"{wire['stream_resets']}, streams {wire['streams_open']}; runner launches {launches}; receiver "
        f"verify_counters {verify}; process CPU {cpu_s:.3f} s ({cpu_s / dt:.2f} cores)")
    for gid, fc in compiles.items():
        log(f"phase 6 ({label}): daemon {gid}: phase.first_compile "
            + (f"{fc[0] * 1e3:.3f} ms (bucket {fc[1]}, rows {fc[2]})" if fc else "not journaled"))
    if split is not None:
        log(f"phase 6 ({label}): " + split.summary())
    log(f"phase 6 ({label}): sender wire: ack lag {wire['ack_lag_ns'] / 1e9:.3f} s summed over frames "
        f"({wire['ack_lag_ns'] / 1e9 / max(wire['frames_sent'], 1):.3f} s a frame), wire stall "
        f"{wire['wire_stall_ns'] / 1e9:.3f} s, frames pipelined {wire['frames_pipelined']}; sender device wait "
        f"{stats['device_wait_ns'] / 1e9:.3f} s summed over workers, batch windows {stats['batch_windows']} "
        f"(rows {stats['batch_rows']}); receiver: decode {decode['decode_ns'] / 1e9:.3f} s summed over "
        f"{decode['decode_workers']} decode workers, REF waits {decode['store_ref_wait_ns'] / 1e9:.3f} s, "
        f"store hits {decode['store_mem_hits']}")
    # the destination's runner works only for paranoid verification
    for d in ((src, dst) if paranoid else (src,)):
        counts = launches[d.gateway_id]
        if any(counts.get(k, 0) == 0 for k in SLICE1):
            raise AssertionError(f"phase 6 ({label}): daemon {d.gateway_id}'s runner launched no {SLICE1}: {counts}")
    for d in (src, dst):
        if any(launches[d.gateway_id].values()) and compiles[d.gateway_id] is None:
            raise AssertionError(f"phase 6 ({label}): daemon {d.gateway_id}'s runner launched kernels but "
                                 "journaled no phase.first_compile")
    if paranoid and verify["verify_batched"] != len(reqs):
        raise AssertionError(f"phase 6 ({label}): {verify['verify_batched']} of {len(reqs)} recipe chunks "
                             f"re-fingerprinted through the destination's runner: {verify}")
    if prof is not None:
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if not events:
            raise AssertionError(f"phase 6 ({label}): the traced round recorded no device events")
        busy_us, top = device_busy(events)
        log(f"phase 6 ({label}) on {card}: traced round: wall {dt:.3f} s, device busy {busy_us / 1e3:.3f} ms = "
            f"{busy_us / 1e6 / dt:.2%} of wall (idle {1 - busy_us / 1e6 / dt:.2%}); device time by name (ms): "
            + "; ".join(f"{name[:60]} {us / 1e3:.3f}" for name, us in top))
    return {"gbps": gbps, "ack_lag_s": wire["ack_lag_ns"] / 1e9, "ref_share": ref_share,
            "restore_wall_s": split.wall_ns["recipe_restore"] / 1e9 if split is not None else None,
            "decode_wall_s": decode["decode_ns"] / 1e9,
            "decode_cpu_s": split.cpu_ns["decode"] / 1e9 if split is not None else None}


def _file_requests(files, chunks):
    from skyplane_tpu_torch.chunk import Chunk, ChunkRequest

    return [
        ChunkRequest(chunk=Chunk(src_key=str(s), dest_key=str(d), chunk_id=uuid.uuid4().hex,
                                 chunk_length_bytes=len(c), file_offset_bytes=0),
                     src_region="local:local", dst_region="local:local", src_type="local", dst_type="local")
        for (s, d), c in zip(files, chunks)
    ]


def _wait_for(pred, timeout: float, what: str) -> float:
    """Poll ``pred`` every 20 ms; seconds waited, or AssertionError at ``timeout``."""
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"phase 6: not within {timeout:.0f} s: {what}")
        time.sleep(0.02)
    return time.monotonic() - t0


def _pump_workers(daemon):
    return [w for owner in daemon._pump_pools() for w in owner.pool.live_workers()]


def pump_round(dev, files, chunks, params, card: str, label: str, procs: int, kill: bool = False) -> dict:
    """One round of phase 6 with ``SKYPLANE_TPU_PUMP_PROCS=procs`` through two
    fresh port daemons: the destination's receiver and the source's sender run
    in ``procs`` worker processes each, on the CPU; the sender workers' codec
    batches are RPCs served by the source daemon's runner on the card (K-AB and
    K-C). Waits until every worker is up and has reported before the POST.
    ``kill`` SIGKILLs one sender worker once a batch RPC has been served, and
    one receiver worker. Returns the round's numbers."""
    import signal

    from skyplane_tpu_torch.gateway.pump import is_pump_sender

    for _, dest in files:
        dest.unlink(missing_ok=True)
    t_spawn = time.perf_counter()
    pair = DaemonPair(dev, params, GATEWAY_DIR / f"round_{label}", pump_procs=procs)
    src, dst = pair.src[0], pair.dst[0]
    try:
        sender = next(op for op in src.operators if is_pump_sender(op))
        _wait_for(lambda: sender.pool is not None and all(
            len(_pump_workers(d)) == procs and all(w.counters.get("runtime") for w in _pump_workers(d))
            for d in (src, dst)), 120, f"{procs} reporting pump workers on each daemon")
        spawn_s = time.perf_counter() - t_spawn
        cpu_before = {d.gateway_id: sum(d._pump_worker_cpu().values()) for d in (src, dst)}
        reqs = _file_requests(files, chunks)
        cpu0, t0 = time.process_time(), time.perf_counter()
        pair.dispatch(reqs)
        killed = []
        if kill:
            _wait_for(lambda: sender.pump_counters()["batch_rpcs_served"] >= 1, 120, "a served batch RPC")
            victim = max(sender.pool.live_workers(), key=lambda w: len(w.outstanding))
            rx_victim = dst.receiver.pump.pool.live_workers()[0]
            for w in (victim, rx_victim):
                os.kill(w.proc.pid, signal.SIGKILL)
                killed.append(w.name)
        pair.wait_complete([r.chunk.chunk_id for r in reqs], timeout=300.0)
        dt, cpu_s = time.perf_counter() - t0, time.process_time() - cpu0
        for i, ((_, dest), c) in enumerate(zip(files, chunks)):
            if hashlib.blake2b(dest.read_bytes(), digest_size=16).digest() != hashlib.blake2b(c, digest_size=16).digest():
                raise AssertionError(f"phase 6 ({label}): destination file {i} differs from its source")
        # the workers push their counters every 0.25 s: wait for the pushes
        # that cover the round (a killed worker's last counts died with it)
        served = lambda: sender.pump_counters()["batch_rpcs_served"]  # noqa: E731
        _wait_for(lambda: (kill or (sender.datapath_counters().get("batch_rpcs_sent", 0) >= served()
                                    and dst.receiver.decode_counters()["decode_chunks"] >= len(reqs)))
                  and all(len(_pump_workers(d)) == procs and all(w.counters.get("runtime") for w in _pump_workers(d))
                          for d in (src, dst)), 60, "the workers' final pushes")
        time.sleep(0.3)  # one more push, for the workers' CPU clocks
        stats = sender.datapath_counters()
        wire = sender.wire_counters()
        decode = dst.receiver.decode_counters()
        pumps = {d.gateway_id: d._pump_counters() for d in (src, dst)}
        worker_cpu_s = sum(sum(d._pump_worker_cpu().values()) - cpu_before[d.gateway_id] for d in (src, dst))
        rx_cpu_s = sum(dst._pump_worker_cpu().values()) - cpu_before[dst.gateway_id]
        runtimes = {w.name: w.counters.get("runtime") for d in (src, dst) for w in _pump_workers(d)}
        launches = src.batch_runner.fused.launch_counts()
        rows = src.batch_runner.counters()["batch_rows"]
        status = pair.get(src, "chunk_status_log", params={"chunk_ids": ",".join(r.chunk.chunk_id for r in reqs)})
        failed = [c for c, st in status["chunk_status"].items() if st == "failed"]
    finally:
        pair.stop()
    raw_total = sum(len(c) for c in chunks)
    gbps = raw_total * 8 / dt / 1e9
    served_n = pumps[src.gateway_id]["batch_rpcs_served"]
    ref_share = stats["ref_segments"] / stats["segments"] if stats["segments"] else 0.0
    log(f"phase 6 ({label}, pump {procs} workers a daemon{', one sender and one receiver worker SIGKILLed: ' + str(killed) if kill else ''}) "
        f"on {card}: {len(reqs)} of {len(reqs)} files written byte-identical, {raw_total} bytes in {dt:.3f} s = "
        f"{gbps:.3f} Gbps from the POST to the last completion (workers up and reporting {spawn_s:.2f} s after "
        f"the daemons' start, before the POST); wire bytes {stats['wire_bytes']}, wire reduction "
        f"{raw_total / stats['wire_bytes']:.3f}x, REF segments {stats['ref_segments']} of {stats['segments']} "
        f"({ref_share:.2%}); NACKs {wire['nacks_reaped']}, resends {wire['frames_sent'] - len(reqs)}, stream resets "
        f"{wire['stream_resets']}; ack lag {wire['ack_lag_ns'] / 1e9:.3f} s summed over frames "
        f"({wire['ack_lag_ns'] / 1e9 / max(wire['frames_sent'], 1):.3f} s a frame)")
    log(f"phase 6 ({label}): batch RPCs served by the source's runner {served_n}, errors "
        f"{pumps[src.gateway_id]['batch_rpc_errors']}, worker fallbacks {stats['batch_rpc_fallbacks']}; the runner's "
        f"launches {launches}, batch rows {rows}; worker CPU {worker_cpu_s:.3f} s summed over {2 * procs} workers "
        f"(receiver workers {rx_cpu_s:.3f} s), parent processes' CPU {cpu_s:.3f} s; receiver workers' decode wall "
        f"{decode['decode_ns'] / 1e9:.3f} s summed over their decode threads ({decode['decode_workers']}), REF "
        f"waits {decode['store_ref_wait_ns'] / 1e9:.3f} s, decode wall over receiver-worker CPU "
        f"{decode['decode_ns'] / 1e9 / max(rx_cpu_s, 1e-9):.2f}x; pump counters {pumps}; failed chunks {len(failed)}")
    log(f"phase 6 ({label}): worker runtime reports {runtimes}")
    if failed:
        raise AssertionError(f"phase 6 ({label}): chunks failed: {failed}")
    if served_n <= 0 or rows < served_n:
        raise AssertionError(f"phase 6 ({label}): batch RPCs served {served_n}, runner rows {rows}")
    if any(launches.get(k, 0) == 0 for k in SLICE1):
        raise AssertionError(f"phase 6 ({label}): the source's runner launched no {SLICE1}: {launches}")
    if pumps[src.gateway_id]["batch_rpc_errors"] or stats["batch_rpc_fallbacks"]:
        raise AssertionError(f"phase 6 ({label}): batch RPC errors or worker fallbacks: {pumps}, {stats}")
    for d in (src, dst):
        pc = pumps[d.gateway_id]
        if kill:
            if pc["worker_respawns"] < 1:
                raise AssertionError(f"phase 6 ({label}): daemon {d.gateway_id} respawned no worker: {pc}")
        elif pc["workers_alive"] != procs or pc["worker_deaths"]:
            raise AssertionError(f"phase 6 ({label}): daemon {d.gateway_id}'s pump is not whole: {pc}")
    bad = {n: r for n, r in runtimes.items()
           if not r or r["cuda_initialized"] or r["jax_loaded"] or r["jax_package_loaded"] or r["device"] != "cpu"}
    if bad or len(runtimes) != 2 * procs:
        raise AssertionError(f"phase 6 ({label}): pump workers off the CPU-only contract: {runtimes}")
    return {"gbps": gbps, "ack_lag_s": wire["ack_lag_ns"] / 1e9, "ref_share": ref_share,
            "decode_wall_s": decode["decode_ns"] / 1e9, "worker_cpu_s": worker_cpu_s, "nacks": wire["nacks_reaped"],
            "ref_wait_s": decode["store_ref_wait_ns"] / 1e9}


def gateway_phase(dev, chunks, params, card: str, main_gbps) -> None:
    """Phase 6: the gateway from 24 source files to 24 destination files
    through two port daemons (see the module docstring)."""
    from skyplane_tpu_torch.native import datapath as native_dp
    from skyplane_tpu_torch.ops import kernels

    native_dp._available = True  # the main path's configuration, pass (b)
    shutil.rmtree(GATEWAY_DIR, ignore_errors=True)
    (GATEWAY_DIR / "src").mkdir(parents=True)
    (GATEWAY_DIR / "dst").mkdir(parents=True)
    files = []
    for i, c in enumerate(chunks):
        src = GATEWAY_DIR / "src" / f"chunk{i:02d}.bin"
        src.write_bytes(c)
        files.append((src, GATEWAY_DIR / "dst" / f"chunk{i:02d}.bin"))
    try:
        sync(dev)
        kernels.reset_launch_counts()
        rounds = [gateway_round(dev, files, chunks, params, card, label, paranoid=True) for label in ("1", "2")]
        sync(dev)
        launches = kernels.launch_counts()
        witness = gateway_round(dev, files, chunks, params, card, "witness", paranoid=False)
        gateway_round(dev, files, chunks, params, card, "traced", paranoid=True, trace=True)
        pumped = {n: pump_round(dev, files, chunks, params, card, f"pump{n}", n) for n in PUMP_PROCS}
        pump_round(dev, files, chunks, params, card, "pump2_kill", 2, kill=True)
    finally:
        shutil.rmtree(GATEWAY_DIR, ignore_errors=True)
    def fmt(r: dict) -> str:
        return (f"{r['gbps']:.3f} Gbps, ack lag {r['ack_lag_s']:.3f} s, REF share {r['ref_share']:.2%}, "
                f"restore wall {r['restore_wall_s']:.3f} s")

    log(f"phase 6 on {card}: paranoid rounds: " + "; ".join(fmt(r) for r in rounds)
        + f"; witness round at the daemon's default (paranoid verify off): {fmt(witness)}"
        + "; phase 3 (b), the sender path alone, in this call: " + ", ".join(f"{g:.3f}" for g in main_gbps)
        + f"; process-wide kernel launches of the two paranoid rounds {launches}")
    log(f"phase 6 on {card}: witness round (in process, paranoid off): {witness['gbps']:.3f} Gbps, ack lag "
        f"{witness['ack_lag_s']:.3f} s, REF share {witness['ref_share']:.2%}, decode wall {witness['decode_wall_s']:.3f} s "
        f"over decode CPU {witness['decode_cpu_s']:.3f} s = {witness['decode_wall_s'] / max(witness['decode_cpu_s'], 1e-9):.2f}x; "
        + "; ".join(f"pump {n}: {r['gbps']:.3f} Gbps, ack lag {r['ack_lag_s']:.3f} s, REF share {r['ref_share']:.2%}, "
                    f"NACKs {r['nacks']}, decode wall {r['decode_wall_s']:.3f} s, worker CPU {r['worker_cpu_s']:.3f} s, "
                    f"REF waits {r['ref_wait_s']:.3f} s"
                    for n, r in pumped.items()))
    if any(launches[k] == 0 for k in SLICE1):
        raise AssertionError(f"a kernel of the gateway path never launched: {launches}")



CLIENT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_client"  # gitignored, inside the checkout
CLIENT_PHASES = {
    "plan": ("phase.plan",),
    "provision": ("phase.provision", "phase.cred_stage", "phase.gateway_boot"),
    "transfer": ("phase.dispatch", "phase.drain"),
    "teardown": ("phase.teardown",),
}


def compute_apps() -> dict:
    """pid -> used MiB of the processes ``nvidia-smi`` lists on the card. In
    the card's sandbox the pids are not this namespace's (every process reads
    as one pid), so the listing shows memory, and ``nvidia_fds`` the pids."""
    r = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    apps = {}
    for line in r.stdout.strip().splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            apps[int(pid)] = apps.get(int(pid), 0) + int(float(mem.strip() or 0))
    return apps


def card_memory_used_mib() -> int:
    """The card's used memory in MiB as ``nvidia-smi --query-gpu=memory.used`` reads it."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60, check=True)
    return int(float(r.stdout.strip().splitlines()[0]))


def nvidia_fds(pid: int) -> list:
    """The NVIDIA device files process ``pid`` holds open: a process with a
    CUDA context on the card holds ``/dev/nvidia<N>``."""
    out = set()
    for fd in Path(f"/proc/{pid}/fd").iterdir():
        try:
            target = os.readlink(fd)
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.add(target)
    return sorted(out)


def _proc_env(pid: int, name: str):
    try:
        raw = Path(f"/proc/{pid}/environ").read_bytes()
    except OSError:
        return None
    for item in raw.split(b"\0"):
        key, _, value = item.partition(b"=")
        if key.decode(errors="replace") == name:
            return value.decode(errors="replace")
    return None


class ClientWitness:
    """Phase 7's view of the two daemons the provisioner spawned, taken by the
    tracker's ``on_transfer_end`` hook while they still run (before the
    dataplane deprovisions): each daemon's pid, device, program,
    ``phase.first_compile`` (``GET /api/v1/events``), compression profile and
    chunk states, and the card's compute processes from ``nvidia-smi``."""

    def __init__(self, gpu: bool):
        from skyplane_tpu_torch.api.tracker import TransferHook

        witness = self
        self.gpu = gpu
        self.dp = None  # the pipeline's dataplane, kept by a wrapper of create_dataplane
        self.daemons = {}
        self.apps_before = compute_apps() if gpu else {}
        self.apps = {}
        self.mem_before = card_memory_used_mib() if gpu else 0
        self.mem_used = 0

        class Hook(TransferHook):
            def on_transfer_end(self) -> None:
                witness.read()

        self.hook = Hook()

    def read(self) -> None:
        for gid, bound in self.dp.bound_gateways.items():
            server, session, url = bound.server, bound.control_session(), bound.control_url()
            events = session.get(f"{url}/events", params={"since": 0}, timeout=30).json()["events"]
            edges = {e["edge"]: e for e in events if e["kind"] == FIRST_COMPILE}
            ids = list(self.dp._trackers[0].dispatched_chunk_ids)
            status = session.get(f"{url}/chunk_status_log", params={"chunk_ids": ",".join(ids)}, timeout=30).json()
            self.daemons[gid] = {
                "region": bound.region_tag,
                "pid": server.proc.pid,
                "device": _proc_env(server.proc.pid, "SKYPLANE_GATEWAY_DEVICE"),
                "nvidia_fds": nvidia_fds(server.proc.pid),
                "program": json.loads((server.workdir / "program.json").read_text()),
                "first_compile": (edges["end"]["mono"] - edges["start"]["mono"], edges["start"]["bucket"],
                                  edges["start"]["rows"]) if set(edges) == {"start", "end"} else None,
                "profile": session.get(f"{url}/profile/compression", timeout=30).json(),
                "kernels": session.get(f"{url}/profile/kernels", timeout=30).json(),
                "metrics": session.get(f"{url}/metrics", timeout=30).text,
                "states": status["chunk_status"],
                "errors": session.get(f"{url}/errors", timeout=30).json()["errors"],
            }
        if self.gpu:
            self.apps = compute_apps()
            self.mem_used = card_memory_used_mib()


def _program_ops(program: dict):
    stack = [op for group in program.get("plan", []) for op in group["value"]]
    while stack:
        op = stack.pop()
        yield op
        stack.extend(op.get("children", []))


def client_phase(chunks, card: str) -> dict:
    """Phase 7: the client path, ``SkyplaneClient.pipeline().start()`` from a
    POSIX site to another through two daemons the local provisioner spawns
    (see the module docstring)."""
    from skyplane_tpu_torch.api.client import SkyplaneClient
    from skyplane_tpu_torch.api.config import TransferConfig
    from skyplane_tpu_torch.api.transfer_job import CopyJob
    from skyplane_tpu_torch.compute.local import local_gateway_device
    from skyplane_tpu_torch.obj_store.posix_file_interface import POSIXInterface
    from skyplane_tpu_torch.obs import get_recorder

    shutil.rmtree(CLIENT_DIR, ignore_errors=True)
    site_a, site_b = CLIENT_DIR / "siteA", CLIENT_DIR / "siteB"
    site_a.mkdir(parents=True)
    site_b.mkdir()
    for i, c in enumerate(chunks):
        (site_a / f"chunk{i:02d}.bin").write_bytes(c)
    device = local_gateway_device()
    cfg = TransferConfig(compress="tpu", dedup=True, auto_codec_decision=False, encrypt_e2e=False,
                         encrypt_socket_tls=False)
    log(f"phase 7: TransferConfig(compress='tpu', dedup=True, auto_codec_decision=False, encrypt_e2e=False, "
        f"encrypt_socket_tls=False), the rest at its defaults (zstd and cryptography are not needed so); daemons on "
        f"'{device}' (SKYPLANE_LOCAL_GATEWAY_PLATFORM), SKYPLANE_TPU_PARANOID_VERIFY=1 so the destination's runner "
        f"re-fingerprints recipe chunks; {len(chunks)} files of {len(chunks[0])} bytes from local:siteA to local:siteB")
    witness = ClientWitness(gpu=device != "cpu")
    saved = os.environ.get("SKYPLANE_TPU_PARANOID_VERIFY")
    os.environ["SKYPLANE_TPU_PARANOID_VERIFY"] = "1"  # inherited by the daemons the provisioner spawns
    client = SkyplaneClient(transfer_config=cfg, log_dir=str(CLIENT_DIR / "client_log"))
    workroot = client.provisioner.provider("local").workroot
    try:
        pipe = client.pipeline(planning_algorithm="direct")
        job = CopyJob("local://siteA/", ["local://siteB/"], recursive=True)
        job._src_iface = POSIXInterface(str(site_a), region_tag="local:siteA")
        job._dst_ifaces = [POSIXInterface(str(site_b), region_tag="local:siteB")]
        job.src_path, job.dst_paths = "local:///", ["local:///"]
        pipe.jobs_to_dispatch.append(job)
        create_dataplane = pipe.create_dataplane

        def keep_dataplane(debug: bool = False):
            witness.dp = create_dataplane(debug)
            return witness.dp

        pipe.create_dataplane = keep_dataplane
        rec = get_recorder()
        since = rec.seq()
        t0 = time.perf_counter()
        stats = pipe.start(hooks=witness.hook)
        wall = time.perf_counter() - t0
        result = check_client_run(witness, chunks, site_b, rec.events_since(since), wall, stats, device, card)
    except BaseException:
        for daemon_log in sorted(workroot.glob("*/daemon.log")) + sorted(workroot.glob("*/logs/*")):
            log(f"phase 7: {daemon_log.relative_to(workroot)}, its last 6000 characters:\n"
                + daemon_log.read_text(errors="replace")[-6000:])
        raise
    finally:
        if saved is None:
            os.environ.pop("SKYPLANE_TPU_PARANOID_VERIFY", None)
        else:
            os.environ["SKYPLANE_TPU_PARANOID_VERIFY"] = saved
        shutil.rmtree(CLIENT_DIR, ignore_errors=True)
        shutil.rmtree(workroot, ignore_errors=True)
    return result


def client_split(events):
    """The client's wall by stage (``CLIENT_PHASES``) and by phase, in
    seconds, from the flight recorder's client-scope phase events."""
    spans = {}
    for e in events:
        if e.get("scope") == "client" and e.get("edge") in ("start", "end"):
            spans.setdefault((e["kind"], e["phase_id"]), {})[e["edge"]] = e["mono"]
    by_kind = {}
    for (kind, _), v in spans.items():
        if len(v) == 2:
            by_kind[kind] = by_kind.get(kind, 0.0) + v["end"] - v["start"]
    return {name: sum(by_kind.get(k, 0.0) for k in kinds) for name, kinds in CLIENT_PHASES.items()}, by_kind


def check_client_run(witness, chunks, site_b: Path, events, wall: float, stats, device: str, card: str) -> dict:
    """Phase 7's checks and lines, from the run and what the hook read."""
    for i, c in enumerate(chunks):
        got = site_b / f"chunk{i:02d}.bin"
        if not got.exists() or got.read_bytes() != c:
            raise AssertionError(f"phase 7: destination file {i} differs from its source")
    split, by_kind = client_split(events)
    tracker = witness.dp._trackers[0]
    ids = set(tracker.dispatched_chunk_ids)
    log(f"phase 7 on {card}: pipe.start() wall {wall:.3f} s: " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
        + " (provision is daemon spawn to ready; transfer is dispatch and drain); by phase: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(by_kind.items())) + "; the planner's codec decisions "
        f"{witness.dp.topology.codec_decisions}")
    log(f"phase 7 on {card}: tracker transfer_stats {stats}; chunks dispatched {len(ids)}, complete "
        f"{len(tracker.complete_chunk_ids)}")
    if len(ids) != len(chunks) or tracker.complete_chunk_ids != ids:
        raise AssertionError(f"phase 7: the tracker dispatched {len(ids)} chunks and reports "
                             f"{len(tracker.complete_chunk_ids & ids)} of them complete")
    if len(witness.daemons) != 2:
        raise AssertionError(f"phase 7: the hook saw {len(witness.daemons)} daemons, not 2")
    for gid, d in witness.daemons.items():
        prof = d["profile"]
        log(f"phase 7: daemon {gid} ({d['region']}, pid {d['pid']}, SKYPLANE_GATEWAY_DEVICE={d['device']}, NVIDIA "
            f"device files open {d['nvidia_fds']}): phase.first_compile (seconds, bucket, rows) {d['first_compile']}; "
            f"kernel launches {d['kernels']}; runner windows {prof.get('batch_windows')}, rows {prof.get('batch_rows')}; raw bytes "
            f"{prof.get('raw_bytes')}, wire bytes {prof.get('wire_bytes')}, segments {prof.get('segments')}, REF "
            f"{prof.get('ref_segments')}")
    used = sum(witness.apps.values()) - sum(witness.apps_before.values())
    log(f"phase 7: nvidia-smi compute apps (pid: MiB) before provisioning {witness.apps_before}, at the transfer's "
        f"end {witness.apps}: {used} MiB more while the daemons ran")
    for gid, d in witness.daemons.items():
        if d["errors"]:
            raise AssertionError(f"phase 7: daemon {gid} reports errors: {d['errors'][0][:2000]}")
        if d["region"] == "local:siteB":
            bad = {c: st for c, st in d["states"].items() if st != "complete"}
            if set(d["states"]) != ids or bad:
                raise AssertionError(f"phase 7: the destination's chunk states are not all complete: {bad}")
        else:
            sends = [op for op in _program_ops(d["program"]) if op["op_type"] == "send"]
            if not sends or any(op.get("compress") != "tpu" or not op.get("dedup") for op in sends):
                raise AssertionError(f"phase 7: the source program's send op is not codec tpu with dedup: {sends}")
        if d["device"] != device:
            raise AssertionError(f"phase 7: daemon {gid} runs on {d['device']!r}, not {device!r}")
        if d["first_compile"] is None:
            raise AssertionError(f"phase 7: daemon {gid} journaled no phase.first_compile (no runner on the card?)")
        if witness.gpu and not any(p.startswith("/dev/nvidia") and p[len("/dev/nvidia"):].isdigit()
                                   for p in d["nvidia_fds"]):
            raise AssertionError(f"phase 7: daemon {gid} (pid {d['pid']}) holds no card open: {d['nvidia_fds']}")
    if witness.gpu and used <= 0:
        raise AssertionError(f"phase 7: the card's used memory did not rise while the daemons ran ({used} MiB)")
    alive = [d["pid"] for d in witness.daemons.values() if Path(f"/proc/{d['pid']}").exists()]
    if alive:
        raise AssertionError(f"phase 7: daemons {alive} outlived deprovisioning")
    log(f"phase 7: all {len(chunks)} destination files byte-identical; both daemons gone after deprovisioning")
    return {"wall_s": wall, "split": split, "stats": stats}

BLAST_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_blast"  # gitignored, inside the checkout
BLAST_SITES = ("siteB", "siteC", "siteD", "siteE")
SERVICE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_service"  # gitignored, inside the checkout


def blast_client_phase(chunks, card: str) -> dict:
    """Phase 8 (a): ``SkyplaneClient.pipeline(planning_algorithm="blast")``
    from one site to four through five daemons the local provisioner spawns
    (see the module docstring)."""
    from skyplane_tpu_torch.api.client import SkyplaneClient
    from skyplane_tpu_torch.api.config import TransferConfig
    from skyplane_tpu_torch.api.transfer_job import CopyJob
    from skyplane_tpu_torch.blast import parse_egress_edges
    from skyplane_tpu_torch.compute.local import local_gateway_device
    from skyplane_tpu_torch.obj_store.posix_file_interface import POSIXInterface
    from skyplane_tpu_torch.obs import get_recorder

    shutil.rmtree(BLAST_DIR, ignore_errors=True)
    site_a = BLAST_DIR / "siteA"
    site_a.mkdir(parents=True)
    for site in BLAST_SITES:
        (BLAST_DIR / site).mkdir()
    for i, c in enumerate(chunks):
        (site_a / f"chunk{i:02d}.bin").write_bytes(c)
    raw_total = sum(len(c) for c in chunks)
    device = local_gateway_device()
    gpu = device != "cpu"
    cfg = TransferConfig(compress="tpu", dedup=True, auto_codec_decision=False, encrypt_e2e=False,
                         encrypt_socket_tls=False)
    log(f"phase 8 (a): pipeline(planning_algorithm='blast'), {len(chunks)} files of {len(chunks[0])} bytes from "
        f"local:siteA to {', '.join('local:' + s for s in BLAST_SITES)}; codec tpu with dedup, plaintext, paranoid "
        f"verify off (the daemon default); daemons on '{device}'")
    witness = ClientWitness(gpu=gpu)
    client = SkyplaneClient(transfer_config=cfg, log_dir=str(BLAST_DIR / "client_log"))
    workroot = client.provisioner.provider("local").workroot
    try:
        pipe = client.pipeline(planning_algorithm="blast")
        job = CopyJob("local://siteA/", ["local:///"] * len(BLAST_SITES), recursive=True)
        job._src_iface = POSIXInterface(str(site_a), region_tag="local:siteA")
        job._dst_ifaces = [POSIXInterface(str(BLAST_DIR / s), region_tag=f"local:{s}") for s in BLAST_SITES]
        job.src_path, job.dst_paths = "local:///", ["local:///"] * len(BLAST_SITES)
        pipe.jobs_to_dispatch.append(job)
        create_dataplane = pipe.create_dataplane

        def keep_dataplane(debug: bool = False):
            witness.dp = create_dataplane(debug)
            return witness.dp

        pipe.create_dataplane = keep_dataplane
        rec = get_recorder()
        since = rec.seq()
        t0 = time.perf_counter()
        stats = pipe.start(hooks=witness.hook)
        wall = time.perf_counter() - t0
        events = rec.events_since(since)
    except BaseException:
        for daemon_log in sorted(workroot.glob("*/daemon.log")) + sorted(workroot.glob("*/logs/*")):
            log(f"phase 8 (a): {daemon_log.relative_to(workroot)}, its last 6000 characters:\n"
                + daemon_log.read_text(errors="replace")[-6000:])
        shutil.rmtree(BLAST_DIR, ignore_errors=True)
        shutil.rmtree(workroot, ignore_errors=True)
        raise
    try:
        for site in BLAST_SITES:
            for i, c in enumerate(chunks):
                got = BLAST_DIR / site / f"chunk{i:02d}.bin"
                if not got.exists() or got.read_bytes() != c:
                    raise AssertionError(f"phase 8 (a): file {i} at local:{site} differs from its source")
    finally:
        shutil.rmtree(BLAST_DIR, ignore_errors=True)
        shutil.rmtree(workroot, ignore_errors=True)
    topo = witness.dp.topology
    tree = topo.metadata["tree"]
    split, by_kind = client_split(events)
    region_of = {gid: g.region_tag for gid, g in topo.gateways.items()}
    src_id = topo.source_gateways()[0].gateway_id
    children = {}
    for p, c in tree["edges"]:
        children.setdefault(p, []).append(c)
    interior = sorted(n for n in children if n != tree["root"])
    edges = {}
    for d in witness.daemons.values():
        edges.update(parse_egress_edges(d["metrics"]))
    gbps = raw_total * len(BLAST_SITES) * 8 / split["transfer"] / 1e9 if split["transfer"] else 0.0
    log(f"phase 8 (a) on {card}: tree {[(region_of[p], region_of[c]) for p, c in tree['edges']]}, solver "
        f"{tree['solver']}, source degree {len(children.get(tree['root'], []))} (bound {tree['source_degree']}), "
        f"fanout {tree['fanout']}, interior relays {[region_of[n] for n in interior]}")
    log(f"phase 8 (a) on {card}: pipe.start() wall {wall:.3f} s: " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
        + f"; {raw_total} bytes x {len(BLAST_SITES)} sinks over the transfer = {gbps:.3f} Gbps; tracker "
        f"transfer_stats {stats}")
    src_egress = sum(n for (a, _), n in edges.items() if a == src_id)
    log(f"phase 8 (a): egress bytes by edge (skyplane_egress_bytes_total): "
        + ", ".join(f"{region_of.get(a, a)}->{region_of.get(b, b)} {n}" for (a, b), n in sorted(edges.items()))
        + f"; the source's egress {src_egress} = {src_egress / raw_total:.4f}x the corpus's raw bytes")
    for gid, d in sorted(witness.daemons.items(), key=lambda kv: kv[1]["region"]):
        prof = d["profile"]
        log(f"phase 8 (a): daemon {d['region']} (pid {d['pid']}, SKYPLANE_GATEWAY_DEVICE={d['device']}, NVIDIA device "
            f"files {d['nvidia_fds']}): kernel launches {d['kernels']}, phase.first_compile (seconds, bucket, rows) "
            f"{d['first_compile']}; sent raw {prof.get('raw_bytes')}, wire {prof.get('wire_bytes')}, REF "
            f"{prof.get('ref_segments')} of {prof.get('segments')} segments")
    if gpu:
        used = sum(witness.apps.values()) - sum(witness.apps_before.values())
        log(f"phase 8 (a): the card's used memory with {len(witness.daemons)} daemons up: nvidia-smi memory.used "
            f"{witness.mem_before} MiB before provisioning, {witness.mem_used} MiB at the transfer's end "
            f"({witness.mem_used - witness.mem_before} MiB more); compute apps (pid: MiB) {witness.apps_before} "
            f"before, {witness.apps} at the end ({used} MiB more)")
    tracker = witness.dp._trackers[0]
    ids = set(tracker.dispatched_chunk_ids)
    if len(ids) != len(chunks) or tracker.complete_chunk_ids != ids:
        raise AssertionError(f"phase 8 (a): the tracker dispatched {len(ids)} chunks and reports "
                             f"{len(tracker.complete_chunk_ids & ids)} of them complete")
    if tree["solver"] != "milp":
        raise AssertionError(f"phase 8 (a): the tree was solved by {tree['solver']!r}, not milp")
    if len(children.get(tree["root"], [])) != 1:
        raise AssertionError(f"phase 8 (a): the source has {len(children.get(tree['root'], []))} tree children, not 1")
    if len(witness.daemons) != 1 + len(BLAST_SITES):
        raise AssertionError(f"phase 8 (a): the hook saw {len(witness.daemons)} daemons, not {1 + len(BLAST_SITES)}")
    for gid, d in witness.daemons.items():
        if d["errors"]:
            raise AssertionError(f"phase 8 (a): daemon {gid} reports errors: {d['errors'][0][:2000]}")
        if d["device"] != device:
            raise AssertionError(f"phase 8 (a): daemon {gid} runs on {d['device']!r}, not {device!r}")
        if gpu and not any(p.startswith("/dev/nvidia") and p[len("/dev/nvidia"):].isdigit() for p in d["nvidia_fds"]):
            raise AssertionError(f"phase 8 (a): daemon {gid} (pid {d['pid']}) holds no card open: {d['nvidia_fds']}")
        if gid == src_id or gid in interior:
            if any(d["kernels"].get(k, 0) == 0 for k in SLICE1):
                raise AssertionError(f"phase 8 (a): daemon {gid} ({d['region']}) launched no {SLICE1}: {d['kernels']}")
            if d["first_compile"] is None:
                raise AssertionError(f"phase 8 (a): daemon {gid} journaled no phase.first_compile")
    alive = [d["pid"] for d in witness.daemons.values() if Path(f"/proc/{d['pid']}").exists()]
    if alive:
        raise AssertionError(f"phase 8 (a): daemons {alive} outlived deprovisioning")
    log(f"phase 8 (a): {len(chunks)} of {len(chunks)} files byte-identical at each of {len(BLAST_SITES)} sinks; all "
        f"{len(witness.daemons)} daemons gone after deprovisioning")
    return {"wall_s": wall, "split": split, "gbps": gbps}


def hard_kill(node: Node) -> None:
    """Stop an in-process daemon as SIGKILL would (as ``hard_kill`` in
    ``tests/integration/harness.py``): operators abandon their queues
    mid-chunk, data sockets close and the control API vanishes."""
    daemon = node.daemon
    for op in daemon.operators:
        op.exit_flag.set()
    try:
        daemon.receiver.stop_all()
    except OSError:
        pass
    daemon.api.stop()
    daemon.stop()
    node.thread.join(timeout=30)


def blast_heal_phase(dev, chunks, params, card: str) -> dict:
    """Phase 8 (b): a blast through in-process daemons on ``dev`` whose first
    relay is hard-killed mid-blast and healed by ``BlastController`` (see the
    module docstring)."""
    import copy

    from skyplane_tpu_torch.blast import BlastController, build_local_blast_programs, solve_blast_tree, start_order
    from skyplane_tpu_torch.ops import kernels

    root = BLAST_DIR / "heal"
    shutil.rmtree(BLAST_DIR, ignore_errors=True)
    (root / "src").mkdir(parents=True)
    sinks = {f"sink_{i}": "local:local" for i in range(len(BLAST_SITES))}
    tree = solve_blast_tree("blast_src", sinks, "local:local", cost_fn=lambda a, b: 0.0, fanout=2, source_degree=1,
                            solver="greedy")
    victim = tree.children(tree.root)[0]
    out_roots = {node: str(root / "out" / node) for node in tree.sinks()}
    # a gateway's connections, divided across its children: 8 on each relay
    # edge of the fanout-2 tree, 16 on the source's one edge
    codec = {"num_connections": 16, "compress": "tpu", "dedup": True}
    programs = build_local_blast_programs(tree, out_roots, **codec)
    files = []
    for i, c in enumerate(chunks):
        src = root / "src" / f"chunk{i:02d}.bin"
        src.write_bytes(c)
        files.append((src, Path(f"/blast/chunk{i:02d}.bin")))
    nodes = {}
    replacements = []

    def start(node_id, prog, info):
        return start_daemon(dev, params, root, node_id, prog["plan"][0]["value"][0], info)

    def factory(dead):
        new_id = f"{dead}+r1"
        roots = dict(out_roots)
        roots[new_id] = roots[dead]  # the replacement writes where the dead sink wrote
        t2 = copy.deepcopy(ctl.tree)
        t2.replace_node(dead, new_id)
        progs = build_local_blast_programs(t2, roots, **codec)
        info = {c: {"public_ip": "127.0.0.1", "control_port": ctl.sinks[c].control_port} for c in t2.children(new_id)}
        node = start(new_id, progs[new_id], info)
        replacements.append(node)
        return new_id, node

    kill = {}

    def kill_check():
        # the relay dies mid-blast once every chunk is registered there: a
        # source whose registration POST to a dead relay outlasts its retry
        # ladder (about 1.5 s) before the heal stops on that error
        done = len(ctl._complete.get(victim, ()))
        if kill or not 0 < done < len(chunks):
            return
        if len(nodes[victim].get("chunk_requests", timeout=30).json()["chunk_requests"]) < len(chunks):
            return
        kill.update(t=time.perf_counter(), done=done)
        hard_kill(nodes[victim])

    try:
        for node_id in start_order(tree):
            info = {c: {"public_ip": "127.0.0.1", "control_port": nodes[c].control_port} for c in tree.children(node_id)}
            nodes[node_id] = start(node_id, programs[node_id], info)
        source = nodes[tree.root]
        sink_nodes = {n: nodes[n] for n in tree.sinks()}
        ctl = BlastController(source, sink_nodes, tree, poll_s=0.05, replacement_factory=factory)
        sync(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ctl.dispatch(_file_requests(files, chunks))
        ctl.wait(timeout=300, kill_check=kill_check)
        t_end = time.perf_counter()
        sync(dev)
        launches = kernels.launch_counts()
        dups = ctl.sink_registration_duplicates()
        for node_id in ctl.sinks:
            out = Path(out_roots.get(node_id, out_roots[victim]))
            for i, c in enumerate(chunks):
                got = out / "blast" / f"chunk{i:02d}.bin"
                if not got.exists() or got.read_bytes() != c:
                    raise AssertionError(f"phase 8 (b): file {i} at sink {node_id} differs from its source after the heal")
        runner = {n.daemon.gateway_id: n.daemon.batch_runner.fused.launch_counts()
                  for n in list(nodes.values()) + replacements}
    finally:
        for node in list(nodes.values()) + replacements:
            try:
                node.stop()
            except Exception:  # noqa: BLE001 — the killed relay is already down
                pass
        shutil.rmtree(BLAST_DIR, ignore_errors=True)
    raw_total = sum(len(c) for c in chunks)
    log(f"phase 8 (b) on {card}: greedy tree {tree.as_dict()['edges']}, codec tpu with dedup, {len(chunks)} files of "
        f"{len(chunks[0])} bytes; relay {victim} hard-killed {kill.get('t', t0) - t0:.3f} s after the POST with "
        f"{kill.get('done')} of {len(chunks)} chunks complete there; relays died {ctl.relays_died}, replacements "
        f"{ctl.replacements}, retargeted ops {ctl.retargeted_ops}, requeued chunks {ctl.requeued_chunks}; converged "
        f"{t_end - kill.get('t', t0):.3f} s after the kill, {t_end - t0:.3f} s after the POST "
        f"({raw_total * len(BLAST_SITES) * 8 / (t_end - t0) / 1e9:.3f} Gbps over the corpus x {len(BLAST_SITES)} sinks); "
        f"duplicate sink registrations {dups}")
    log(f"phase 8 (b): kernel launches in this process {launches}; by daemon runner {runner}")
    if not kill:
        raise AssertionError("phase 8 (b): the relay kill never fired (the blast finished before a poll saw it mid-way)")
    if ctl.relays_died != [victim] or ctl.replacements != [f"{victim}+r1"]:
        raise AssertionError(f"phase 8 (b): healed {ctl.relays_died} with {ctl.replacements}, not {victim}")
    if dups:
        raise AssertionError(f"phase 8 (b): {dups} duplicate chunk registrations at the sinks")
    if any(launches.get(k, 0) == 0 for k in SLICE1) or any(runner[tree.root].get(k, 0) == 0 for k in SLICE1):
        raise AssertionError(f"phase 8 (b): the source's runner launched no {SLICE1}: {runner[tree.root]}")
    return {"heal_s": t_end - kill["t"], "launches": launches}


def _drive_job(controller, job_id: str, timeout: float = 300.0) -> float:
    """Poll the sink every 10 ms until the job is done or failed; seconds."""
    t0 = time.perf_counter()
    while controller.job(job_id).state not in ("done", "failed"):
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"phase 9: job {job_id} still {controller.job(job_id).state} after {timeout:.0f} s")
        controller.poll_once()
        time.sleep(0.01)
    return time.perf_counter() - t0


def service_phase(dev, chunks, params, card: str, provision_s: float) -> dict:
    """Phase 9: the always-on service over a standing pair of port daemons on
    ``dev`` (see the module docstring)."""
    from skyplane_tpu_torch.api.client import SkyplaneClient
    from skyplane_tpu_torch.ops import kernels

    shutil.rmtree(SERVICE_DIR, ignore_errors=True)
    src_dir, dst_dir = SERVICE_DIR / "corpus", SERVICE_DIR / "mirror"
    src_dir.mkdir(parents=True)
    for i, c in enumerate(chunks):
        (src_dir / f"chunk{i:02d}.bin").write_bytes(c)
    pair = DaemonPair(dev, params, SERVICE_DIR / "fleet")
    src, dst = pair.src[0], pair.dst[0]
    sender = next(op for op in src.operators if type(op).__name__ == "GatewaySenderOperator")
    client = SkyplaneClient(log_dir=str(SERVICE_DIR / "client_log"))
    urls = {"source_url": f"http://127.0.0.1:{src.api.port}/api/v1", "sink_url": f"http://127.0.0.1:{dst.api.port}/api/v1"}
    wal = SERVICE_DIR / "wal"
    rows = []

    def measure(label, controller, submit):
        """Start a job by ``submit`` (which returns its id), drive it to its
        end, and keep its numbers."""
        before, runner0 = sender.datapath_counters(), src.batch_runner.fused.launch_counts()
        t0 = time.perf_counter()
        job_id = submit()
        _drive_job(controller, job_id)
        dt = time.perf_counter() - t0
        job = controller.job(job_id)
        after, runner1 = sender.datapath_counters(), src.batch_runner.fused.launch_counts()
        raw = sum(d["length"] for d in job.chunks.values())
        wire = after["wire_bytes"] - before["wire_bytes"]
        segs, refs = after["segments"] - before["segments"], after["ref_segments"] - before["ref_segments"]
        row = {
            "label": label, "job": job, "state": job.state, "start_latency_s": job.start_latency_s,
            "chunks": len(job.chunks), "raw": raw, "wire": wire, "seconds": dt,
            "gbps": raw * 8 / dt / 1e9 if dt else 0.0, "ref_share": refs / segs if segs else 0.0,
            "launches": {k: runner1.get(k, 0) - runner0.get(k, 0) for k in SLICE1},
        }
        rows.append(row)
        return row

    try:
        sync(dev)
        kernels.reset_launch_counts()
        c1 = client.service(wal, chunk_bytes=len(chunks[0]), **urls)
        c1.attach()
        ids = {}
        measure("sync", c1, lambda: c1.submit({"type": "sync", "src": str(src_dir), "dst": str(dst_dir)},
                                              idem_key="chip-sync"))
        # recovery: the controller goes away right after the submit while the fleet keeps pumping
        one = src_dir / "chunk00.bin"
        t_sub = time.perf_counter()
        ids["copy"] = c1.submit({"type": "copy", "src": str(one), "dst": str(SERVICE_DIR / "copied" / one.name)},
                                idem_key="chip-copy")
        copy_latency = c1.job(ids["copy"]).start_latency_s
        c1.close()
        c2 = client.service(wal, chunk_bytes=len(chunks[0]), **urls)
        c2.attach()
        rec = c2.recover()
        _drive_job(c2, ids["copy"])
        copy_s = time.perf_counter() - t_sub
        copy_job = c2.job(ids["copy"])
        registered = [cr["chunk"]["chunk_id"] for cr in pair.get(dst, "chunk_requests")["chunk_requests"]]
        copy_regs = {cid: registered.count(cid) for cid in copy_job.chunks}
        # continuous sync: one file of the corpus becomes the next snapshot's
        ids["watch"] = c2.submit({"type": "sync_watch", "src": str(src_dir), "dst": str(dst_dir), "interval_s": 0.0},
                                 idem_key="chip-watch")
        idle_rounds = c2.run_watch_rounds()
        changed = src_dir / "chunk01.bin"
        changed.write_bytes(chunks[1 + CHUNKS_PER_SNAPSHOT])
        spawned = {}

        def watch_round() -> str:
            spawned["n"] = c2.run_watch_rounds()
            return c2._idem[f"{ids['watch']}:r0"]

        watch_row = measure("watch round", c2, watch_round)
        sync(dev)
        launches = kernels.launch_counts()
        status = c2.status()
        c2.close()
        mismatched = [f.name for f in sorted(src_dir.iterdir()) if (dst_dir / f.name).read_bytes() != f.read_bytes()]
        copied_ok = (SERVICE_DIR / "copied" / one.name).read_bytes() == one.read_bytes()
    finally:
        pair.stop()
        shutil.rmtree(SERVICE_DIR, ignore_errors=True)
    for r in rows:
        log(f"phase 9 on {card}: {r['label']} job {r['job'].job_id}: {r['state']}, start latency (submit to "
            f"dispatched) {r['start_latency_s'] * 1e3:.3f} ms, {r['chunks']} chunks posted, {r['raw']} bytes in "
            f"{r['seconds']:.3f} s = {r['gbps']:.3f} Gbps, wire bytes {r['wire']} (reduction "
            f"{r['raw'] / r['wire'] if r['wire'] else float('inf'):.3f}x), REF share {r['ref_share']:.2%}, the source "
            f"runner's launches {r['launches']}")
    log(f"phase 9: recovery: copy job {ids['copy']} dispatched in {copy_latency * 1e3:.3f} ms, its controller closed "
        f"right after; the new controller's recover() {rec}; job {copy_job.state} {copy_s:.3f} s after the submit; the "
        f"sink's registrations of its chunks {copy_regs}")
    log(f"phase 9: watch: rounds spawned with no change {idle_rounds}, after {changed.name} changed {spawned.get('n')}; "
        f"the round's chunks from {sorted({Path(d['src_key']).name for d in watch_row['job'].chunks.values()})}")
    log(f"phase 9 on {card}: start latency (submit to dispatched) of the service's jobs "
        + ", ".join(f"{r['label']} {r['start_latency_s'] * 1e3:.3f} ms" for r in rows)
        + f", copy {copy_latency * 1e3:.3f} ms; beside phase 7's provision {provision_s:.3f} s before its first "
        f"chunk could move; process kernel launches {launches}; controller status {status}")
    bad = [r["label"] for r in rows if r["state"] != "done"] + ([] if copy_job.state == "done" else ["copy"])
    if bad:
        raise AssertionError(f"phase 9: jobs {bad} did not end done")
    if mismatched or not copied_ok:
        raise AssertionError(f"phase 9: files differ at the sink: {mismatched}, copy {'ok' if copied_ok else 'differs'}")
    if ids["copy"] not in rec["adopted_jobs"]:
        raise AssertionError(f"phase 9: recover() did not adopt the copy job: {rec}")
    if any(n != 1 for n in copy_regs.values()):
        raise AssertionError(f"phase 9: the recovered job's chunks were registered at the sink {copy_regs} times")
    if idle_rounds != 0 or spawned.get("n") != 1:
        raise AssertionError(f"phase 9: watch rounds spawned {idle_rounds} with no change and {spawned.get('n')} after one")
    if {Path(d["src_key"]).name for d in watch_row["job"].chunks.values()} != {changed.name}:
        raise AssertionError("phase 9: the watch round shipped chunks of an unchanged file")
    if any(launches.get(k, 0) == 0 for k in SLICE1) or any(rows[0]["launches"][k] == 0 for k in SLICE1):
        raise AssertionError(f"phase 9: the source runner launched no {SLICE1}: {rows[0]['launches']}, {launches}")
    return {"rows": rows, "launches": launches}


# ---- phase 10: the command line (slice 12) ----

CLI_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"  # gitignored, inside the checkout
DAEMON_MODULE = "skyplane_tpu_torch.gateway.gateway_daemon"


def cli_run(args, label: str, timeout: float, env_extra=None, check: bool = True):
    """Run ``python -m skyplane_tpu_torch.cli.cli ARGS`` as a user does, with a
    fresh ``SKYPLANE_TPU_CONFIG_ROOT`` and a time limit; returns (rc, stdout,
    stderr, wall seconds). ``check`` fails unless rc is 0."""
    env = {**os.environ, "SKYPLANE_TPU_CONFIG_ROOT": str(CLI_DIR / f"config_{uuid.uuid4().hex[:8]}"), **(env_extra or {})}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "skyplane_tpu_torch.cli.cli", *map(str, args)], cwd=Path(__file__).resolve().parent,
                       env=env, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if check and r.returncode != 0:
        raise AssertionError(f"phase 10: {label} exited {r.returncode}:\n{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    return r.returncode, r.stdout, r.stderr, wall


def _ppid(pid: int) -> int:
    try:
        return int(Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[1])
    except (OSError, IndexError, ValueError):
        return -1


class DaemonWatch:
    """Phase 10 (a)'s view of the gateway daemons a CLI process spawns: a
    thread that scans ``/proc`` every 50 ms for children of that process
    running the daemon module, and keeps each one's device
    (``SKYPLANE_GATEWAY_DEVICE``) and the NVIDIA device files it held open."""

    def __init__(self, parent_pid: int):
        self.parent = parent_pid
        self.daemons = {}
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._scan, daemon=True)
        self.thread.start()

    def _scan(self) -> None:
        while not self.stop.is_set():
            for p in Path("/proc").iterdir():
                if not p.name.isdigit() or _ppid(int(p.name)) != self.parent:
                    continue
                pid = int(p.name)
                try:
                    cmd = (p / "cmdline").read_bytes().split(b"\0")
                except OSError:
                    continue
                if DAEMON_MODULE.encode() not in cmd:
                    continue
                d = self.daemons.setdefault(pid, {"device": _proc_env(pid, "SKYPLANE_GATEWAY_DEVICE"), "nvidia_fds": []})
                try:
                    d["nvidia_fds"] = sorted(set(d["nvidia_fds"]) | set(nvidia_fds(pid)))
                except OSError:
                    pass
            self.stop.wait(0.05)

    def close(self) -> dict:
        self.stop.set()
        self.thread.join(timeout=10)
        return self.daemons


def _transfer_line(stdout: str):
    """(Gbps, wire reduction or None) from the lines after "Transfer complete."."""
    import re

    lines = stdout.splitlines()
    at = next((i for i, ln in enumerate(lines) if "Transfer complete." in ln), None)
    if at is None:
        raise AssertionError(f"phase 10: no 'Transfer complete.' line in:\n{stdout[-4000:]}")
    summary = " ".join(lines[at + 1:at + 3])
    gbps = re.search(r"\(([0-9.]+) Gbps effective\)", summary)
    red = re.search(r"wire reduction ([0-9.]+)x", summary)
    if gbps is None:
        raise AssertionError(f"phase 10: no Gbps in the summary {summary!r}")
    return float(gbps.group(1)), (float(red.group(1)) if red else None), summary.strip()


def cli_cp_phase(chunks, card: str) -> dict:
    """Phase 10 (a): ``cp -r`` between two local roots through the CLI, with
    ``--compress tpu --dedup`` so it does not delegate to ``rsync``/``cp`` (see
    the module docstring)."""
    from skyplane_tpu_torch.compute.local import local_gateway_device

    site_a, site_c, fleet = CLI_DIR / "siteA", CLI_DIR / "siteC", CLI_DIR / "fleet_a"
    site_a.mkdir(parents=True)
    for i, c in enumerate(chunks):
        (site_a / f"chunk{i:02d}.bin").write_bytes(c)
    device = local_gateway_device()
    args = ["cp", "-r", f"local://{site_a}/", f"local://{site_c}/", "-y", "--compress", "tpu", "--dedup"]
    log(f"phase 10 (a): {' '.join(args)}; daemons on '{device}' (the device default), SKYPLANE_TPU_COLLECT=1 with "
        f"the fleet log under {fleet.name}/. Both endpoints parse to POSIX interfaces tagged local:local, so the "
        f"planner makes a same-region plan (one gateway: read -> write, no send, codec none) and no kernel launches, "
        f"as in the JAX package")
    env = {**os.environ, "SKYPLANE_TPU_CONFIG_ROOT": str(CLI_DIR / "config_cp"), "SKYPLANE_TPU_COLLECT": "1",
           "SKYPLANE_TPU_FLEET_DIR": str(fleet)}
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "skyplane_tpu_torch.cli.cli", *args], cwd=Path(__file__).resolve().parent,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    watch = DaemonWatch(proc.pid)
    try:
        stdout, stderr = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
        raise AssertionError(f"phase 10 (a): cp ran past 300 s:\n{stdout[-4000:]}\n{stderr[-4000:]}")
    finally:
        daemons = watch.close()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 10 (a): cp exited {proc.returncode}:\n{stdout[-4000:]}\n{stderr[-4000:]}")
    gbps, reduction, summary = _transfer_line(stdout)
    same = sum((site_c / f"chunk{i:02d}.bin").exists() and (site_c / f"chunk{i:02d}.bin").read_bytes() == c
               for i, c in enumerate(chunks))
    log(f"phase 10 (a) on {card}: the CLI process's wall {wall:.3f} s; its summary '{summary}': {gbps} Gbps effective, "
        f"wire reduction {'absent (the same-region plan sends nothing)' if reduction is None else f'{reduction}x'}; "
        f"{same} of {len(chunks)} files byte-identical")
    if same != len(chunks):
        raise AssertionError(f"phase 10 (a): {same} of {len(chunks)} destination files byte-identical")
    log(f"phase 10 (a): daemons the CLI spawned (pid: device, NVIDIA device files held) "
        + ", ".join(f"{pid}: {d['device']}, {d['nvidia_fds']}" for pid, d in daemons.items()))
    if not daemons:
        raise AssertionError("phase 10 (a): saw no gateway daemon spawned by the CLI")
    for pid, d in daemons.items():
        if d["device"] != device:
            raise AssertionError(f"phase 10 (a): daemon {pid} runs on {d['device']!r}, not {device!r}")
        if device != "cpu" and not any(p.startswith("/dev/nvidia") and p[len("/dev/nvidia"):].isdigit()
                                       for p in d["nvidia_fds"]):
            raise AssertionError(f"phase 10 (a): daemon {pid} held no card open: {d['nvidia_fds']}")
    alive = []
    for pid in daemons:
        try:
            if DAEMON_MODULE.encode() in Path(f"/proc/{pid}/cmdline").read_bytes().split(b"\0"):
                alive.append(pid)
        except OSError:
            pass  # gone
    if alive:
        raise AssertionError(f"phase 10 (a): daemons {alive} outlived the CLI")
    _, out, _, tl_wall = cli_run(["timeline", "latest", "--fleet-dir", fleet, "--json"], "timeline", 120)
    report = json.loads(out)
    phases = {p["name"]: p["dur_s"] for p in report["timeline"]["phases"]}
    log(f"phase 10 (a): timeline latest --fleet-dir --json ({tl_wall:.2f} s): wall {report['timeline']['wall_s']:.3f} s, "
        f"stages " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
        + f"; transfer {report['timeline']['transfer_seconds']} s for {report['timeline']['bytes']} bytes")
    if FIRST_COMPILE.split(".")[1] in phases:
        raise AssertionError(f"phase 10 (a): the same-region plan journaled a first compile: {phases}")
    if not {"plan", "gateway_boot", "dispatch", "drain"} <= set(phases):
        raise AssertionError(f"phase 10 (a): the fleet log lacks stages: {sorted(phases)}")
    _, out, _, ls_wall = cli_run(["cloud", "ls", f"local://{site_c}/"], "cloud ls", 120)
    last = out.strip().splitlines()[-1]
    log(f"phase 10 (a): cloud ls of the destination ({ls_wall:.2f} s): '{last}'")
    if last != f"{len(chunks)} objects":
        raise AssertionError(f"phase 10 (a): cloud ls reads {last!r}")
    return {"wall_s": wall, "gbps": gbps, "stages": phases}


def _status(wal: Path) -> dict:
    try:
        return json.loads((wal / "status.json").read_text())
    except (OSError, ValueError):
        return {}


def _dirs_equal(a: Path, b: Path, want=None) -> bool:
    want = want or {f.name: f.read_bytes() for f in a.iterdir()}
    return all((b / n).exists() and (b / n).read_bytes() == v for n, v in want.items())


def cli_service_phase(dev, chunks, params, card: str) -> dict:
    """Phase 10 (b): ``serve`` and ``sync --watch`` through the CLI over a
    standing pair of port daemons on ``dev``, then ``monitor``, ``tenants``,
    ``trace export`` and ``bottleneck`` against it (see the module docstring)."""
    from skyplane_tpu_torch.obs import configure_tracer
    from skyplane_tpu_torch.ops import kernels

    corpus, copy_dst, mirror = CLI_DIR / "corpus", CLI_DIR / "copy", CLI_DIR / "mirror"
    wal, spool = CLI_DIR / "wal", CLI_DIR / "spool"
    corpus.mkdir(parents=True)
    spool.mkdir()
    for i, c in enumerate(chunks):
        (corpus / f"chunk{i:02d}.bin").write_bytes(c)
    original = {f.name: f.read_bytes() for f in corpus.iterdir()}
    configure_tracer(sample=1.0)  # the daemons' spans, for trace export and bottleneck
    pair = DaemonPair(dev, params, CLI_DIR / "fleet_b")
    src, dst = pair.src[0], pair.dst[0]
    sender = next(op for op in src.operators if type(op).__name__ == "GatewaySenderOperator")
    u1, u2 = f"http://127.0.0.1:{src.api.port}", f"http://127.0.0.1:{dst.api.port}"
    serve_log = (CLI_DIR / "serve.log").open("w")
    serve = subprocess.Popen(
        [sys.executable, "-m", "skyplane_tpu_torch.cli.cli", "serve", "--wal-dir", str(wal), "--spool", str(spool),
         "--source-url", u1, "--sink-url", u2, "--poll-s", "0.05", "--chunk-mb", str(CHUNK_MB)],
        cwd=Path(__file__).resolve().parent, env={**os.environ, "SKYPLANE_TPU_CONFIG_ROOT": str(CLI_DIR / "config_serve")},
        stdout=serve_log, stderr=subprocess.STDOUT)
    rows, tools = [], {}
    try:
        log(f"phase 10 (b): serve --wal-dir --spool --source-url {u1} --sink-url {u2} --poll-s 0.05 --chunk-mb {CHUNK_MB} "
            f"(pid {serve.pid}) over phase 6's pair on {dev}")

        def step(label, start, done_jobs, rounds):
            """Run ``start``, which returns the wall-clock time its spec or
            change was in place, then wait until status.json shows
            ``done_jobs`` jobs done and ``rounds`` watch rounds; keep the
            step's numbers, timed from that moment."""
            c0 = sender.datapath_counters()
            t0 = start()
            deadline = time.time() + 300
            while True:
                st = _status(wal)
                if st.get("jobs_by_state", {}).get("done", 0) >= done_jobs and st.get("watch_rounds", 0) >= rounds:
                    break
                if serve.poll() is not None:
                    raise AssertionError(f"phase 10 (b): serve exited {serve.returncode} during {label}")
                if st.get("jobs_by_state", {}).get("failed") or time.time() > deadline:
                    raise AssertionError(f"phase 10 (b): {label}: status {st}")
                time.sleep(0.01)
            dt = time.time() - t0
            c1 = sender.datapath_counters()
            segs, refs = c1["segments"] - c0["segments"], c1["ref_segments"] - c0["ref_segments"]
            raw, wire = c1["raw_bytes"] - c0["raw_bytes"], c1["wire_bytes"] - c0["wire_bytes"]
            rows.append({"label": label, "seconds": dt, "raw": raw, "wire": wire, "gbps": raw * 8 / dt / 1e9,
                         "reduction": raw / wire if wire else float("inf"), "ref_share": refs / segs if segs else 0.0})

        def drop_copy():
            spec = spool / "copy-corpus.json"
            spec.with_suffix(".tmp").write_text(json.dumps({"type": "copy", "src": str(corpus), "dst": str(copy_dst)}))
            os.replace(spec.with_suffix(".tmp"), spec)
            return time.time()

        watch_out = {}

        def queue_watch():
            """The spec's time is its file's (the serve loop may start the
            round while the CLI process is still exiting)."""
            _, out, _, w = cli_run(["sync", corpus, mirror, "--watch", "--interval", "1", "--spool", spool], "sync --watch", 120)
            watch_out["line"], watch_out["wall"] = out.strip(), w
            return (spool / out.split(" as ")[1].split()[0]).stat().st_mtime

        def change_one():
            changed.write_bytes(chunks[1 + CHUNKS_PER_SNAPSHOT])
            return time.time()

        changed = corpus / "chunk01.bin"
        t_ready = _wait_for(lambda: serve.poll() is not None or (wal / "status.json").exists(), 120,
                            "serve's first status.json")
        if serve.poll() is not None:
            raise AssertionError(f"phase 10 (b): serve exited {serve.returncode} at start")
        log(f"phase 10 (b): serve wrote its first status.json {t_ready:.3f} s after the poll began")
        sync(dev)
        kernels.reset_launch_counts()
        k0 = pair.get(src, "profile/kernels")
        r0 = src.batch_runner.fused.launch_counts()
        step("copy job (spool)", drop_copy, 1, 0)
        step("watch round 0", queue_watch, 2, 1)
        step("watch round 1", change_one, 3, 2)
        sync(dev)
        launches = kernels.launch_counts()
        k1 = pair.get(src, "profile/kernels")
        r1 = src.batch_runner.fused.launch_counts()
        status = _status(wal)
        copied_ok = _dirs_equal(corpus, copy_dst, original)
        mirrored_ok = _dirs_equal(corpus, mirror)
        trace = CLI_DIR / "t.json"
        for name, args, want in (
            ("monitor", ["monitor", "--url", u1, "--url", u2, "--once"], ("gw_src", "gw_dst")),
            ("tenants", ["tenants", "--url", u1], ("tenants",)),
            ("trace export", ["trace", "export", "--url", u1, "--url", u2, "-o", trace], ("events to",)),
            ("bottleneck", ["bottleneck", "--trace", trace], ("",)),
        ):
            _, out, _, w = cli_run(args, name, 120)
            if not all(s in out for s in want) or not out.strip() or "STALE" in out or "no tenants" in out:
                raise AssertionError(f"phase 10 (b): {name} printed:\n{out[-4000:]}")
            tools[name] = (w, out)
        trace_pids = {e.get("pid") for e in json.loads(trace.read_text())["traceEvents"] if e.get("ph") != "M"}
    finally:
        t_term = time.perf_counter()
        serve.send_signal(signal.SIGTERM)
        try:
            serve.wait(timeout=30)
        except subprocess.TimeoutExpired:
            serve.kill()
            serve.wait()
            raise AssertionError("phase 10 (b): serve did not exit within 30 s of SIGTERM")
        finally:
            term_s = time.perf_counter() - t_term
            serve_log.close()
            pair.stop()
            configure_tracer(sample=None)
    log(f"phase 10 (b): sync --watch printed '{watch_out['line']}'; the command took {watch_out['wall']:.2f} s (it "
        f"imports the transfer path before it writes the spec, as the JAX CLI does)")
    for r in rows:
        log(f"phase 10 (b) on {card}: {r['label']}: {r['raw']} raw bytes in {r['seconds']:.3f} s from the spec or the "
            f"change in place to status.json = {r['gbps']:.3f} Gbps, wire bytes {r['wire']} (reduction {r['reduction']:.3f}x), REF share "
            f"{r['ref_share']:.2%}")
    delta = {k: k1.get(k, 0) - k0.get(k, 0) for k in SLICE1}
    runner = {k: r1.get(k, 0) - r0.get(k, 0) for k in SLICE1}
    log(f"phase 10 (b) on {card}: status.json jobs {status.get('jobs_by_state')}, watch rounds "
        f"{status.get('watch_rounds')}, job start latency (submit to dispatched) p50 {status.get('job_start_p50_s')} s, "
        f"p95 {status.get('job_start_p95_s')} s, dispatch histogram p50 {status.get('dispatch_hist_p50_s')} s; the "
        f"source daemon's GET /api/v1/profile/kernels launches during (b) {delta}, its runner's {runner}, the process's "
        f"{launches}; serve exited {serve.returncode} {term_s:.3f} s after SIGTERM")
    for name, (w, out) in tools.items():
        log(f"phase 10 (b): {name} ({w:.2f} s), its first lines:\n" + "\n".join(out.strip().splitlines()[:6]))
    if not copied_ok or not mirrored_ok:
        raise AssertionError(f"phase 10 (b): files differ: copy {'ok' if copied_ok else 'differs'}, mirror "
                             f"{'ok' if mirrored_ok else 'differs'}")
    if status.get("jobs_by_state") != {"done": 3, "watching": 1} or status.get("watch_rounds", 0) < 2:
        raise AssertionError(f"phase 10 (b): status.json {status}")
    if any(delta[k] <= 0 for k in SLICE1) or any(runner[k] <= 0 for k in SLICE1):
        raise AssertionError(f"phase 10 (b): the source daemon launched no {SLICE1}: {delta}, runner {runner}")
    if len(trace_pids) != 2:
        raise AssertionError(f"phase 10 (b): the merged trace holds spans of {len(trace_pids)} gateways, not 2")
    if serve.returncode != 0:
        raise AssertionError(f"phase 10 (b): serve exited {serve.returncode}: {(CLI_DIR / 'serve.log').read_text()[-4000:]}")
    return {"rows": rows, "launches": launches}


def cli_phase(dev, chunks, params, card: str) -> dict:
    """Phase 10: the command line, (a) then (b), in a fresh ``CLI_DIR``."""
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        cp = cli_cp_phase(chunks, card)
        torch.cuda.empty_cache()
        service = cli_service_phase(dev, chunks, params, card)
    finally:
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return {"cp": cp, "service": service}


# ---- phase 11: the multi-device data path (slice 13) ----

SPMD_MESHES = ((1, 1), (1, 2), (2, 2), (2, 4))  # (data, seq)
SPMD_DRYRUN_DEVICES = 4
# the kernels of the SPMD path: the step's three (K-A' with and without a
# halo) and the meshed runner's two (dryrun_multichip)
SPMD_PATH = ("gear_compact", "segment_fp", "gear_mask", "gear_mask_halo", "segment_fp_fixed", "blockpack_encode")


def halo_with_candidate(first: int, mask_bits: int, rng) -> np.ndarray:
    """32 halo bytes that make the first byte of a shard (whose first byte is
    ``first``) a candidate: h_0 = G[first] + sum_k G[halo[32 - k]] << k."""
    from skyplane_tpu_torch.ops.gear import GEAR_TABLE

    g = GEAR_TABLE.astype(np.uint64)
    while True:
        halos = rng.integers(0, 256, (1 << 16, 32), dtype=np.uint8)
        h = np.full(len(halos), g[first], np.uint64)
        for k in range(1, 32):
            h += g[halos[:, 32 - k]] << np.uint64(k)
        hit = np.flatnonzero(((h & np.uint64(0xFFFFFFFF)) >> np.uint64(32 - mask_bits)) == 0)
        if len(hit):
            return halos[hit[0]]


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def trace_busy(fn, reps: int):
    """``reps`` calls of ``fn`` under torch.profiler: (wall ms, device busy
    ms) per call, or a string saying why it was not measured."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync_all()
    try:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    except Exception as err:  # noqa: BLE001 — the profiler, not the port
        return f"not measured (profiler did not start: {err!r})"
    try:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync_all()
        wall = time.perf_counter() - t0
    finally:
        prof.stop()
    try:
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as err:  # noqa: BLE001 — the profiler, not the port
        return f"not measured (profiler events unreadable: {err!r})"
    if not events:
        return "not measured (no device events traced)"
    busy_us, _ = device_busy(events)
    return wall * 1e3 / reps, busy_us / 1e3 / reps


def spmd_drive(batch, placements) -> dict:
    """Phase 11 (a)'s drive: ``make_spmd_datapath`` over each (shape,
    devices) once on ``batch``. Returns shape -> (mesh, step, outputs,
    kernel launches of that one step)."""
    from skyplane_tpu_torch.ops import kernels
    from skyplane_tpu_torch.parallel.datapath_spmd import Mesh, make_spmd_datapath

    bucket = batch.shape[1]
    res = {}
    for shape, devices in placements:
        mesh = Mesh(devices, shape)
        step = make_spmd_datapath(mesh, bucket, batch.shape[0], STEP_BLOCK, STEP_FP_SEG, STEP_MASK_BITS)
        before = kernels.launch_counts()
        out = step(batch)
        sync_all()
        after = kernels.launch_counts()
        res[shape] = (mesh, step, out, {k: after[k] - before[k] for k in after})
    return res


def spmd_check(batch, rows, ref, drive: dict, card: str, label: str) -> dict:
    """Phase 11 (a)'s checks of each mesh's step: three launches a position
    (K-A' with a halo on every position past a row's first), candidates, tags
    and fingerprints equal to ``datapath_step``'s, n_lit summing to its
    counts, every row's per-shard literals decoding byte-identical on the
    host; then its time by CUDA events. Returns shape -> step ms."""
    from skyplane_tpu_torch.ops.host_fallback import blockpack_decode_host

    bucket = batch.shape[1]
    ms = {}
    for (data, seq), (mesh, step, out, launches) in drive.items():
        n = data * seq
        want = {"gear_mask": n, "gear_mask_halo": data * (seq - 1), "blockpack_encode": n, "segment_fp_fixed": n}
        got = {k: launches.get(k, 0) for k in want}
        if got != want or sum(launches.values()) - launches["gear_mask_halo"] != 3 * n:
            raise AssertionError(f"phase 11 {label}: mesh {data}x{seq}: launches {launches}, want {want}")
        for k in ("candidates", "tags", "fp_lanes"):
            if not torch.equal(out[k], ref[k]):
                raise AssertionError(f"phase 11 {label}: mesh {data}x{seq}: {k} differ from datapath_step")
        n_lit = out["n_lit"].cpu().numpy()
        if not np.array_equal(n_lit.sum(1), ref["n_lit"].cpu().numpy()):
            raise AssertionError(f"phase 11 {label}: mesh {data}x{seq}: n_lit does not sum to datapath_step's")
        if n == 1 and not torch.equal(out["literals"], ref["literals"]):
            raise AssertionError(f"phase 11 {label}: mesh 1x1: literals differ from datapath_step")
        n_local = bucket // seq
        tags = out["tags"].cpu().numpy().reshape(len(rows), seq, n_local // STEP_BLOCK)
        lits = out["literals"].cpu().numpy().reshape(len(rows), seq, n_local)
        for i in range(len(rows)):
            for s in range(seq):
                back = blockpack_decode_host(tags[i, s], lits[i, s, : n_lit[i, s]], STEP_BLOCK)
                if not np.array_equal(back, rows[i, s * n_local : (s + 1) * n_local]):
                    raise AssertionError(f"phase 11 {label}: mesh {data}x{seq}: row {i} shard {s} does not decode")
        ms[(data, seq)] = time_ms(lambda: step(batch), 10)
        traced = trace_busy(lambda: step(batch), 10)
        if not isinstance(traced, str):
            traced = (f"traced wall {traced[0]:.4f} ms, device busy {traced[1]:.4f} ms per step "
                      f"(idle {1 - traced[1] / traced[0]:.2%})")
        log(f"phase 11 {label}: mesh {data}x{seq} on {[str(d) for d in mesh.devices]}: launches per step {got} "
            f"(= {n} positions x 3); outputs equal datapath_step, all {len(rows)} rows x {seq} shards decode "
            f"byte-identical; step {ms[(data, seq)]:.4f} ms by events, {traced}; on {card}")
        del out
    torch.cuda.empty_cache()
    return ms


def spmd_halo(dev, batch, card: str) -> dict:
    """Phase 11 (a): K-A' with a halo against its plain version on the 2x4
    mesh's shards and on adversarial halos, its time beside its bound, and
    the slab and halo copies a position makes."""
    from skyplane_tpu_torch.ops import kernels
    from skyplane_tpu_torch.state import device_tables

    tables = device_tables(dev)
    data, seq = SPMD_MESHES[-1]
    b_local, n_local = batch.shape[0] // data, batch.shape[1] // seq
    err = 0
    for r in range(data):
        for s in range(1, seq):
            rows = slice(r * b_local, (r + 1) * b_local)
            slab = batch[rows, s * n_local : (s + 1) * n_local].contiguous()
            halo = batch[rows, s * n_local - 32 : s * n_local].contiguous()
            err = max(err, max_abs_err(kernels.gear_mask(slab, tables, STEP_MASK_BITS, halo=halo),
                                       kernels.gear_mask_plain(slab, tables, STEP_MASK_BITS, halo)))
    rng = np.random.default_rng(11)
    adv = rng.integers(0, 256, (b_local, n_local), dtype=np.uint8)
    adv_halo = rng.integers(0, 256, (b_local, 32), dtype=np.uint8)
    adv[0, :4096], adv_halo[0] = 0, 0  # a shard boundary inside a run of zeros
    adv[1, :4096], adv_halo[1] = 0x5A, 0x5A  # ... and inside a run of 0x5A
    adv_halo[2] = halo_with_candidate(int(adv[2, 0]), STEP_MASK_BITS, rng)  # a candidate on the first byte
    adv_t, adv_h = torch.from_numpy(adv).to(dev), torch.from_numpy(adv_halo).to(dev)
    plain = kernels.gear_mask_plain(adv_t, tables, STEP_MASK_BITS, adv_h)
    if not bool(plain[2, 0]):
        raise AssertionError("phase 11: the adversarial halo put no candidate on the shard's first byte")
    adv_err = max_abs_err(kernels.gear_mask(adv_t, tables, STEP_MASK_BITS, halo=adv_h), plain)
    # the trap at mask bits 1 (half the positions are candidates): shard 0 of
    # a row has no halo, and 32 zero bytes in its place change the front's hash
    no_halo = kernels.gear_mask(adv_t, tables, 1)
    zero_halo = kernels.gear_mask(adv_t, tables, 1, halo=torch.zeros_like(adv_h))
    trap = int((no_halo != zero_halo).sum())
    log(f"phase 11 (a): K-A' with a halo, max |kernel - plain| {err} on the {data * (seq - 1)} halo shards of "
        f"mesh {data}x{seq} ([{b_local}, {n_local}] each), {adv_err} on adversarial halos (a boundary inside a run "
        f"of zeros and of 0x5A, a candidate on the first byte); at mask bits 1, no halo and a halo of 32 zero "
        f"bytes differ in {trap} positions (why shard 0 passes none)")
    if err or adv_err or not trap:
        raise AssertionError(f"phase 11: K-A' with a halo disagrees with its plain version: {err}, {adv_err}")
    slab = batch[0:b_local, n_local : 2 * n_local].contiguous()
    halo = batch[0:b_local, n_local - 32 : n_local].contiguous()
    ms = time_ms(lambda: kernels.gear_mask(slab, tables, STEP_MASK_BITS, halo=halo), 50)
    plain_ms = time_ms(lambda: kernels.gear_mask_plain(slab, tables, STEP_MASK_BITS, halo), 3, 1)
    no_halo_ms = time_ms(lambda: kernels.gear_mask(slab, tables, STEP_MASK_BITS), 50)
    traced = traced_ms(lambda: kernels.gear_mask(slab, tables, STEP_MASK_BITS, halo=halo), "gear_mask", 50)
    no_halo_traced = traced_ms(lambda: kernels.gear_mask(slab, tables, STEP_MASK_BITS), "gear_mask", 50)
    slab_ms = time_ms(lambda: batch[0:b_local, n_local : 2 * n_local].contiguous(), 20)
    halo_ms = time_ms(lambda: slab[:, -32:].contiguous(), 50)
    n = slab.numel()
    # read the slab, its halo and the table; write one byte per byte; per byte
    # the hash step (one shift-add) and the top-bits test
    bound, by = bound_ms(n + 32 * b_local + 1024 + n, 2 * n)
    log(f"phase 11 (a) on {card}: K-A' with a halo on [{b_local}, {n_local}]: {ms:.4f} ms/launch (without the halo "
        f"{no_halo_ms:.4f} ms; plain {plain_ms:.3f} ms) by events, bound {bound:.4f} ms ({by}), {bound / ms:.1%} of "
        f"bound; traced: {traced}; without the halo {no_halo_traced}; "
        f"a position's slab copy (a strided [{b_local}, {n_local}] column block made contiguous) {slab_ms:.4f} ms, "
        f"its halo copy ([{b_local}, 32]) {halo_ms:.4f} ms")
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "max_abs_err": max(err, adv_err),
            "traced": traced}


def spmd_dryrun(dev, label: str, card: str) -> dict:
    """Phase 11 (b): ``dryrun_multichip(4)`` with SKYPLANE_TPU_SPMD_CHECK=1
    (every sharded window held against the host recompute in the runner)."""
    from skyplane_tpu_torch.entry import dryrun_multichip

    saved = os.environ.get("SKYPLANE_TPU_SPMD_CHECK")
    os.environ["SKYPLANE_TPU_SPMD_CHECK"] = "1"  # read by each runner's constructor
    try:
        t0 = time.perf_counter()
        res = dryrun_multichip(SPMD_DRYRUN_DEVICES, device=dev, prod_chunk=CHUNK_MB << 20)
        wall = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("SKYPLANE_TPU_SPMD_CHECK", None)
        else:
            os.environ["SKYPLANE_TPU_SPMD_CHECK"] = saved
    per_pos = [{k: c.get(k, 0) for k in SLICE1} for c in res["prod_launches"]]
    if res["prod_counters"]["spmd_check_batches"] < 1 or any(0 in c.values() for c in per_pos):
        raise AssertionError(f"phase 11 {label}: a position launched no K-AB or K-C, or no window was checked: {res}")
    log(f"phase 11 {label} on {card}: dryrun_multichip({SPMD_DRYRUN_DEVICES}) mesh {res['mesh']} on {res['devices']}: "
        f"{wall:.2f} s; production window {res['prod_window_s']:.3f} s; K-AB and K-C launches per position: "
        f"stage 1 {[{k: c.get(k, 0) for k in SLICE1} for c in res['stage1_launches']]}, production {per_pos}; "
        f"windows checked against the host {res['prod_counters']['spmd_check_batches']}; "
        f"REF segments on the near-duplicate {res['ref_segments']}")
    return res


def spmd_daemon(dev, params, card: str) -> None:
    """Phase 11 (c): a port daemon in process with SKYPLANE_TPU_SPMD=on builds
    its runner: unsharded on one card, a mesh over every card on 2^k >= 2."""
    n = torch.cuda.device_count()
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_spmd"
    shutil.rmtree(root, ignore_errors=True)
    saved = os.environ.get("SKYPLANE_TPU_SPMD")
    os.environ["SKYPLANE_TPU_SPMD"] = "on"
    try:
        recv = {"op_type": "receive", "handle": "recv", "dedup": True,
                "children": [{"op_type": "write_local", "handle": "write", "children": []}]}
        node = start_daemon(dev, params, root, "gw_spmd", recv, {})
    finally:
        if saved is None:
            os.environ.pop("SKYPLANE_TPU_SPMD", None)
        else:
            os.environ["SKYPLANE_TPU_SPMD"] = saved
    try:
        runner = node.daemon.batch_runner
        mesh = runner.mesh
        want_mesh = n > 1 and n & (n - 1) == 0
        if (mesh is not None) != want_mesh or (mesh is not None and mesh.devices != [torch.device("cuda", i) for i in range(n)]):
            raise AssertionError(f"phase 11 (c): {n} card(s), runner mesh {mesh}")
        log(f"phase 11 (c) on {card}: SKYPLANE_TPU_SPMD=on daemon built its runner on {runner.device}, "
            f"mesh {dict(mesh.shape) if mesh is not None else None} ({n} card(s)), spmd_devices {runner.counters()['spmd_devices']}")
    finally:
        node.stop()
        shutil.rmtree(root, ignore_errors=True)


def spmd_phase(dev, chunks, params, card: str) -> dict:
    """Phase 11: the multi-device data path. Returns the launches of its
    drive (every mesh's first step and the dry run), K-A' with a halo's
    numbers, and the step times."""
    from skyplane_tpu_torch.entry import mesh_devices
    from skyplane_tpu_torch.ops import kernels
    from skyplane_tpu_torch.ops.pipeline import datapath_step
    from skyplane_tpu_torch.tools.spmd_scaling import point_label, spmd_scaling

    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    rows = np.stack([np.frombuffer(c, np.uint8) for c in chunks[:MAX_BATCH]])
    batch = torch.from_numpy(rows).to(dev)
    ref = datapath_step(batch, block_bytes=STEP_BLOCK, fp_seg_bytes=STEP_FP_SEG, mask_bits=STEP_MASK_BITS)
    single_ms = time_ms(lambda: datapath_step(batch, block_bytes=STEP_BLOCK, fp_seg_bytes=STEP_FP_SEG,
                                              mask_bits=STEP_MASK_BITS), 10)
    placements = [(shape, mesh_devices(shape[0] * shape[1], dev)) for shape in SPMD_MESHES]

    sync_all()
    kernels.reset_launch_counts()
    drive = spmd_drive(batch, placements)
    spmd_dryrun(dev, "(b)", card)
    sync_all()
    launches = kernels.launch_counts()
    log(f"phase 11: kernel launches of the drive (each mesh's first step, then the dry run): {launches}")
    if any(launches[k] == 0 for k in SPMD_PATH):
        raise AssertionError(f"phase 11: a kernel of the SPMD path never launched: {launches}")

    step_ms = spmd_check(batch, rows, ref, drive, card, "(a)")
    del drive
    log(f"phase 11 (a) on {card}: datapath_step {single_ms:.4f} ms beside the step over meshes "
        + ", ".join(f"{d}x{s} {ms:.4f} ms" for (d, s), ms in step_ms.items())
        + f" ({point_label(mesh_devices(8, dev))} for the 2x4 mesh)")
    halo = spmd_halo(dev, batch, card)
    del batch, ref
    torch.cuda.empty_cache()
    spmd_daemon(dev, params, card)

    for row in spmd_scaling(dev, (1, 2, 4, 8), chunk_mb=1, reps=3):
        log(f"phase 11 scaling on {card}: {row['n']} position(s), mesh {row['mesh']} on {row['devices']}: "
            f"{row['gbps']:.3f} Gbps, identical to the host path ({row['label']})")

    if n_cards >= 2:  # (d): distinct cards
        before = torch.cuda.current_device()
        last = torch.device("cuda", n_cards - 1)
        from skyplane_tpu_torch.state import device_tables

        kernels.gear_mask(torch.zeros((1, 8192), dtype=torch.uint8, device=last), device_tables(last), 12)
        torch.cuda.synchronize(last)
        if torch.cuda.current_device() != before:
            raise AssertionError(f"phase 11 (d): a launch on {last} moved the current device from {before}")
        batch = torch.from_numpy(rows).to(dev)
        ref = datapath_step(batch, block_bytes=STEP_BLOCK, fp_seg_bytes=STEP_FP_SEG, mask_bits=STEP_MASK_BITS)
        fits = [(s, [torch.device("cuda", i) for i in range(s[0] * s[1])]) for s in SPMD_MESHES if s[0] * s[1] <= n_cards]
        spmd_check(batch, rows, ref, spmd_drive(batch, fits), card, "(d)")
        del batch, ref
        spmd_dryrun(dev, "(d)", card)
        log(f"phase 11 (d): current device {before} unchanged after a launch on {last}")
    else:
        log(f"phase 11 (d) not run: the machine has {n_cards} card(s), so no mesh spans distinct cards and no launch "
            "can move the current device to another card (the repeated-card meshes of (a) and (b) ran instead)")
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "halo": halo, "step_ms": step_ms, "single_ms": single_ms}


# ---- phase 12: the cloud gateway path ----

CLOUD_OBJECT_CHUNKS = 4  # corpus chunks per S3 object: 6 objects of 32 MiB, each a 4-part multipart upload
CLOUD_SRC = ("skyplane-tpu-src", "us-east-1")
CLOUD_DST = ("skyplane-tpu-dst", "us-west-2")
CLOUD_BOOT_PROGRAM = {"plan": [{"partitions": ["default"], "value": [
    {"op_type": "read_local", "handle": "read", "num_connections": 1,
     "children": [{"op_type": "write_local", "handle": "write", "children": []}]}]}]}


def cloud_util():
    """``tests/torch_cloud_util.py`` (the sandbox VM and the boto3 stand-in,
    shared with the CPU tests), loaded from its file: a ``tests`` package
    installed on the machine would shadow the checkout's."""
    import importlib.util

    mod = sys.modules.get("torch_cloud_util")
    if mod is None:
        path = Path(__file__).resolve().parent / "tests" / "torch_cloud_util.py"
        spec = importlib.util.spec_from_file_location("torch_cloud_util", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["torch_cloud_util"] = mod
        spec.loader.exec_module(mod)
    return mod


def _cloud_get(vm, route: str, **params):
    return vm.control_session().get(f"{vm.control_url()}/{route}", params=params or None, timeout=30).json()


def _vm_command_seconds(vm, since: int = 0) -> dict:
    """Wall seconds of a sandbox VM's bootstrap commands after index ``since``:
    the venv, the pip installs, the rest."""
    out = {"venv": 0.0, "pip": 0.0, "other": 0.0}
    for cmd, sec in vm.command_seconds[since:]:
        key = "venv" if cmd.startswith("python3 -m venv") else "pip" if "pip install" in cmd else "other"
        out[key] += sec
    return out


def _check_vm_daemon(vm, want_id: str, device: str, what: str) -> dict:
    """A sandbox VM's daemon: one process, started from the VM's venv without
    SKYPLANE_GATEWAY_DEVICE (on the card), answering /status with
    ``want_id``, on ``device``; on the card it holds a card open."""
    from skyplane_tpu_torch.compute import bootstrap

    pids = vm.daemon_pids()
    if len(pids) != 1:
        raise AssertionError(f"phase 12 {what}: {vm.instance_id} runs {len(pids)} daemons ({pids}), not 1")
    status = _cloud_get(vm, "status")
    builds = _cloud_get(vm, "profile/kernel_builds")
    cmdline = Path(f"/proc/{pids[0]}/cmdline").read_bytes().split(b"\0")[0].decode()
    env_device = _proc_env(pids[0], "SKYPLANE_GATEWAY_DEVICE")
    fds = nvidia_fds(pids[0]) if device != "cpu" else []
    log(f"phase 12 {what}: {vm.instance_id} daemon pid {pids[0]} from {cmdline}, SKYPLANE_GATEWAY_DEVICE "
        f"{env_device!r}, /status {status}, its device {builds['device']!r}, NVIDIA device files open {fds}")
    if status.get("gateway_id") != want_id or status.get("error"):
        raise AssertionError(f"phase 12 {what}: /status {status}, not gateway {want_id} without error")
    if cmdline != str(vm.remote(bootstrap.REMOTE_PY)):
        raise AssertionError(f"phase 12 {what}: the daemon runs from {cmdline}, not the VM's venv")
    if builds["device"] != device:
        raise AssertionError(f"phase 12 {what}: the daemon is on {builds['device']!r}, not {device!r}")
    if device != "cpu":
        if env_device is not None:
            raise AssertionError(f"phase 12 {what}: the daemon was given SKYPLANE_GATEWAY_DEVICE={env_device!r}")
        if not any(f[len("/dev/nvidia"):].isdigit() for f in fds):
            raise AssertionError(f"phase 12 {what}: the daemon holds no card open: {fds}")
    return {"pid": pids[0], "builds": builds}


def cloud_boot(vm, card: str, device: str) -> dict:
    """Phase 12 (a): the port's wheel, a sandbox VM's venv and install, its
    daemon; then a second ``start_gateway`` that must skip the installs."""
    from skyplane_tpu_torch.compute import bootstrap

    t0 = time.perf_counter()
    wheel = bootstrap.build_wheel()
    names = bootstrap.wheel_listing()
    sources = sorted(n for n in names if n.endswith((".cu", ".cuh", ".cpp")))
    requires = [line.split(":", 1)[1].strip() for line in bootstrap.wheel_metadata().splitlines()
                if line.startswith("Requires-Dist:") and "extra ==" not in line]
    log(f"phase 12 (a) on {card}: wheel {wheel.name}: {bootstrap.wheel_info['bytes']} bytes, built in "
        f"{bootstrap.wheel_info['seconds']:.3f} s; {len(names)} entries, of them {len(sources)} kernel and host-library "
        f"sources; requires {requires}")
    if any(n.startswith("skyplane_tpu/") for n in names) or any(r.startswith("jax") for r in requires):
        raise AssertionError("phase 12 (a): the wheel holds the JAX package or requires jax")
    if not {"skyplane_tpu_torch/csrc/gear_compact.cu", "skyplane_tpu_torch/csrc/segment_fp.cu"} <= set(sources):
        raise AssertionError(f"phase 12 (a): the wheel lacks the kernels' sources: {sources}")
    t1 = time.perf_counter()
    vm.start_gateway(CLOUD_BOOT_PROGRAM, {}, "boot_a", use_tls=False, use_bbr=False)
    boot_s = time.perf_counter() - t1
    cmd_s = _vm_command_seconds(vm)
    first = _check_vm_daemon(vm, "boot_a", device, "(a)")
    log(f"phase 12 (a) on {card}: start_gateway {boot_s:.3f} s (venv {cmd_s['venv']:.3f} s, pip installs "
        f"{cmd_s['pip']:.3f} s, other commands {cmd_s['other']:.3f} s, the rest the daemon's start to /status); "
        f"{vm.pip_installs()} pip installs")
    n_cmds, n_installs = len(vm.command_seconds), vm.pip_installs()
    t1 = time.perf_counter()
    vm.start_gateway(CLOUD_BOOT_PROGRAM, {}, "boot_a2", use_tls=False, use_bbr=False)
    restart_s = time.perf_counter() - t1
    second = _check_vm_daemon(vm, "boot_a2", device, "(a) restart")
    if vm.pip_installs() != n_installs:
        raise AssertionError(f"phase 12 (a): the second start_gateway ran {vm.pip_installs() - n_installs} pip installs")
    if second["pid"] == first["pid"]:
        raise AssertionError("phase 12 (a): the second start_gateway did not restart the daemon")
    log(f"phase 12 (a) on {card}: the second start_gateway skipped the installs (the wheel's sha256 matched) and "
        f"restarted the daemon in {restart_s:.3f} s (commands {_vm_command_seconds(vm, n_cmds)}); "
        f"{time.perf_counter() - t0:.1f} s in all")
    return {"wheel_s": bootstrap.wheel_info["seconds"], "wheel_bytes": bootstrap.wheel_info["bytes"], "boot_s": boot_s,
            "venv_s": cmd_s["venv"], "pip_s": cmd_s["pip"], "restart_s": restart_s}


class CloudWitness:
    """Phase 12 (b)'s view of the sandbox VMs' daemons, read by the tracker's
    ``on_transfer_end`` hook before the dataplane deprovisions them."""

    def __init__(self):
        from skyplane_tpu_torch.api.tracker import TransferHook

        witness = self
        self.dp = None
        self.daemons = {}

        class Hook(TransferHook):
            def on_transfer_end(self) -> None:
                witness.read()

        self.hook = Hook()

    def read(self) -> None:
        for gid, bound in self.dp.bound_gateways.items():
            vm = bound.server
            events = _cloud_get(vm, "events", since=0)["events"]
            edges = {e["edge"]: e for e in events if e["kind"] == FIRST_COMPILE}
            self.daemons[gid] = {
                "vm": vm, "region": bound.region_tag, "pids": vm.daemon_pids(),
                "kernels": _cloud_get(vm, "profile/kernels"),
                "builds": _cloud_get(vm, "profile/kernel_builds"),
                "profile": _cloud_get(vm, "profile/compression"),
                "errors": _cloud_get(vm, "errors")["errors"],
                "first_compile": (edges["end"]["mono"] - edges["start"]["mono"]) if set(edges) == {"start", "end"} else None,
            }


def cloud_transfer(boto3, chunks, work: Path, vm_a, new_vm, card: str, device: str) -> dict:
    """Phase 12 (b): S3 -> S3 through the port's client path, two sandbox VMs
    booted by ``SSHServer.start_gateway`` from the wheel."""
    from skyplane_tpu_torch.api.client import SkyplaneClient
    from skyplane_tpu_torch.api.config import TransferConfig
    from skyplane_tpu_torch.compute import bootstrap
    from skyplane_tpu_torch.obs import get_recorder

    s3 = boto3.client("s3", region_name=CLOUD_SRC[1])
    for bucket, region in (CLOUD_SRC, CLOUD_DST):
        boto3.create_bucket_dir(bucket, region)
    objects = {f"snapshots/obj{i}.bin": b"".join(chunks[i * CLOUD_OBJECT_CHUNKS:(i + 1) * CLOUD_OBJECT_CHUNKS])
               for i in range(len(chunks) // CLOUD_OBJECT_CHUNKS)}
    for key, blob in objects.items():
        s3.put_object(Bucket=CLOUD_SRC[0], Key=key, Body=blob)
    raw = sum(len(b) for b in objects.values())

    def provision(region_tag: str):
        return vm_a if region_tag == vm_a.region_tag else new_vm("vm_b", region_tag)

    provider = cloud_util().make_sandbox_provider("aws", provision)
    part_mb = len(chunks[0]) >> 20
    cfg = TransferConfig(compress="tpu", dedup=True, auto_codec_decision=False, encrypt_e2e=False,
                         encrypt_socket_tls=False, multipart_threshold_mb=2 * part_mb, multipart_chunk_size_mb=part_mb)
    log(f"phase 12 (b): {len(objects)} objects of {len(next(iter(objects.values())))} bytes from "
        f"s3://{CLOUD_SRC[0]} (aws:{CLOUD_SRC[1]}) to s3://{CLOUD_DST[0]} (aws:{CLOUD_DST[1]}), parts of {part_mb} MiB; "
        "TransferConfig(compress='tpu', dedup=True, auto_codec_decision=False, encrypt_e2e=False, "
        "encrypt_socket_tls=False); the provisioner's aws provider returns sandbox VMs (vm_a reused from (a)); "
        "SKYPLANE_TPU_PARANOID_VERIFY=1 on the VMs")
    client = SkyplaneClient(transfer_config=cfg, log_dir=str(work / "client_log"))
    client.provisioner._providers["aws"] = provider
    pipe = client.pipeline(planning_algorithm="direct")
    pipe.queue_copy(f"s3://{CLOUD_SRC[0]}/", f"s3://{CLOUD_DST[0]}/", recursive=True)
    witness = CloudWitness()
    create_dataplane = pipe.create_dataplane

    def keep_dataplane(debug: bool = False):
        witness.dp = create_dataplane(debug)
        return witness.dp

    pipe.create_dataplane = keep_dataplane
    installs_a = vm_a.pip_installs()
    rec = get_recorder()
    since = rec.seq()
    boto3.calls.clear()
    t0 = time.perf_counter()
    stats = pipe.start(hooks=witness.hook)
    wall = time.perf_counter() - t0
    split, by_kind = client_split(rec.events_since(since))
    gbps = raw * 8 / split["transfer"] / 1e9 if split["transfer"] else float("nan")
    log(f"phase 12 (b) on {card}: pipe.start() wall {wall:.3f} s: " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
        + f" (provision is the sandbox VMs' boot: vm_a's restart, vm_b's venv, install and daemon); by phase: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(by_kind.items()))
        + f"; {raw} raw bytes in the transfer stage: {gbps:.4f} Gbps; tracker transfer_stats {stats}")

    # every destination object byte-identical, each a 4-part multipart upload
    listed = {o["Key"]: o["Size"] for page in s3.get_paginator("list_objects_v2").paginate(Bucket=CLOUD_DST[0])
              for o in page.get("Contents", [])}
    if sorted(listed) != sorted(objects):
        raise AssertionError(f"phase 12 (b): the destination holds {sorted(listed)}, not {sorted(objects)}")
    for key, blob in objects.items():
        got = s3.get_object(Bucket=CLOUD_DST[0], Key=key)["Body"].read()
        if hashlib.sha256(got).digest() != hashlib.sha256(blob).digest():
            raise AssertionError(f"phase 12 (b): s3://{CLOUD_DST[0]}/{key} differs from its source")
    completes = [kw for op, kw in boto3.calls if op == "complete_multipart_upload"]
    parts = sorted(len(kw["MultipartUpload"]["Parts"]) for kw in completes)
    if parts != [len(chunks[0:CLOUD_OBJECT_CHUNKS])] * len(objects):
        raise AssertionError(f"phase 12 (b): the client completed multipart uploads of {parts} parts, not "
                             f"{len(objects)} of {CLOUD_OBJECT_CHUNKS}")
    log(f"phase 12 (b): all {len(objects)} destination objects sha256-identical to their sources; the client "
        f"completed {len(completes)} multipart uploads of {parts[0]} parts each")
    if vm_a.pip_installs() != installs_a:
        raise AssertionError("phase 12 (b): the source VM re-ran its pip installs")
    if len(witness.daemons) != 2:
        raise AssertionError(f"phase 12 (b): the hook saw {len(witness.daemons)} daemons, not 2")
    launches = {}
    for gid, d in witness.daemons.items():
        vm, builds, prof = d["vm"], d["builds"], d["profile"]
        log(f"phase 12 (b): daemon {gid} on {vm.instance_id} ({d['region']}, pids {d['pids']}, device "
            f"{builds['device']!r}): kernel launches {d['kernels']}; phase.first_compile {d['first_compile']} s; runner "
            f"windows {prof.get('batch_windows')}, raw bytes {prof.get('raw_bytes')}, wire bytes {prof.get('wire_bytes')}, "
            f"segments {prof.get('segments')}, REF {prof.get('ref_segments')}")
        for name, b in sorted(builds["builds"].items()):
            log(f"phase 12 (b): {vm.instance_id} built {name} in {b['seconds']:.3f} s into {b['path']} from {b['source']}")
        if builds.get("native"):
            log(f"phase 12 (b): {vm.instance_id} native host library {builds['native']}")
        if d["errors"]:
            raise AssertionError(f"phase 12 (b): daemon {gid} reports errors: {d['errors'][0][:2000]}")
        if builds["device"] != device:
            raise AssertionError(f"phase 12 (b): daemon {gid} is on {builds['device']!r}, not {device!r}")
        want = ("gear_compact", "segment_fp") if d["region"] == vm_a.region_tag else ("segment_fp",)
        if device != "cpu":
            for name in want:
                if d["kernels"].get(name, 0) <= 0:
                    raise AssertionError(f"phase 12 (b): daemon {gid} ({d['region']}) launched no {name}: {d['kernels']}")
                b = builds["builds"].get(name)
                root_build, venv = vm.remote(bootstrap.REMOTE_BUILD_DIR), vm.remote(bootstrap.REMOTE_VENV)
                if b is None or Path(b["path"]).parent != root_build or not b["source"].startswith(str(venv)):
                    raise AssertionError(f"phase 12 (b): {name} of daemon {gid} was not built from the wheel's source "
                                         f"under the VM's root: {b}")
        for name, n in d["kernels"].items():
            launches[name] = launches.get(name, 0) + n
    left = [vm.instance_id for vm in (d["vm"] for d in witness.daemons.values()) if vm.daemon_pids()]
    if left:
        raise AssertionError(f"phase 12 (b): daemons of {left} outlived deprovisioning")
    log(f"phase 12 (b): both daemons gone after deprovisioning; launches on the cloud path (both daemons) {launches}")
    return {"wall_s": wall, "split": split, "gbps": gbps, "launches": launches}


def cloud_phase(chunks, card: str, device: str) -> dict:
    """Phase 12: the cloud gateway path (see the module docstring). Returns
    (a)'s and (b)'s numbers and the daemons' kernel launches."""
    import tempfile

    util = cloud_util()
    FAKE_S3_ROOT_ENV, SandboxVM, fake_sdk_modules = util.FAKE_S3_ROOT_ENV, util.SandboxVM, util.fake_sdk_modules

    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_cloud_"))  # outside the checkout, as a VM's home is
    sdk, store = work / "sdk", work / "store"
    saved = os.environ.get("SKYPLANE_TPU_BOOTSTRAP_PIP_ARGS")
    # no package index: the VMs take torch and the rest from the image's site-packages
    os.environ["SKYPLANE_TPU_BOOTSTRAP_PIP_ARGS"] = "--no-deps"
    vm_env = {FAKE_S3_ROOT_ENV: str(store), "SKYPLANE_TPU_PARANOID_VERIFY": "1"}
    if device == "cpu":
        vm_env["SKYPLANE_GATEWAY_DEVICE"] = "cpu"
    vms = []

    def new_vm(name: str, region_tag: str):
        vm = SandboxVM(work / name, region_tag=region_tag, instance_id=f"sandbox-{name}", env=vm_env,
                       extra_path=[str(sdk)])
        vms.append(vm)
        return vm

    try:
        with fake_sdk_modules(sdk, store, also=("skyplane_tpu_torch.obj_store.s3_interface",
                                                "skyplane_tpu_torch.obj_store.r2_interface",
                                                "skyplane_tpu_torch.compute.aws.")) as boto3:
            log(f"phase 12: sandbox VMs under {work} (PYTHONPATH: torch's site-packages {util.torch_site_packages()} and "
                f"the boto3 stand-in {sdk}; cwd outside the checkout), S3 buckets in {store}")
            boot = cloud_boot(new_vm("vm_a", f"aws:{CLOUD_SRC[1]}"), card, device)
            transfer = cloud_transfer(boto3, chunks, work, vms[0], new_vm, card, device)
    except BaseException:
        for vm in vms:
            log(f"phase 12: {vm.instance_id}'s daemon log, its last 6000 characters:\n{vm.daemon_log()[-6000:]}")
        raise
    finally:
        for vm in vms:
            vm.stop_daemon()
        if saved is None:
            os.environ.pop("SKYPLANE_TPU_BOOTSTRAP_PIP_ARGS", None)
        else:
            os.environ["SKYPLANE_TPU_BOOTSTRAP_PIP_ARGS"] = saved
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    return {"boot": boot, "transfer": transfer, "launches": transfer["launches"]}


# ---- phase 13: a multicast across the IBM Cloud, Azure and SCP gateways ----

MULTICLOUD_OBJECTS = 3  # the corpus's first two snapshots: 3 objects of 4 chunks (phase 12 moves all 6: a depth cut)
MULTICLOUD_SRC = ("us-south", "skyplane-tpu-src")  # cos://us-south/skyplane-tpu-src
MULTICLOUD_AZURE = ("skyplanetpu", "skyplane-tpu-dst")  # azure://skyplanetpu/skyplane-tpu-dst
MULTICLOUD_SCP = "skyplane-tpu-dst"  # scp://skyplane-tpu-dst
MULTICLOUD_TAGS = ("cos:us-south", "azure:infer", "scp:kr-west-1")  # what the backends derive from those paths
# the providers' settings, every endpoint on this host: the stand-ins ignore
# them, and an SCP open-API call would meet a closed local port. The Azure
# service principal is what the non-Azure gateways are shipped for Blob.
MULTICLOUD_ENV = {
    "IBM_API_KEY_ID": "sandbox-ibm-key", "IBM_SERVICE_INSTANCE_ID": "sandbox-instance",
    "SCP_OBS_ENDPOINT": "http://127.0.0.1:9", "SCP_API_ENDPOINT": "http://127.0.0.1:9",
    "SCP_ACCESS_KEY": "sandbox-scp-key", "SCP_SECRET_KEY": "sandbox-scp-secret", "SCP_PROJECT_ID": None,
    "AZURE_CLIENT_ID": "sandbox-client", "AZURE_TENANT_ID": "sandbox-tenant", "AZURE_CLIENT_SECRET": "sandbox-secret",
}
MULTICLOUD_MODULES = tuple(f"skyplane_tpu_torch.{m}" for m in (
    "obj_store.s3_interface", "obj_store.r2_interface", "obj_store.cos_interface", "obj_store.scp_interface",
    "obj_store.azure_blob_interface", "compute.aws.", "compute.azure.", "compute.ibmcloud.", "compute.scp."))


class MulticloudWitness(CloudWitness):
    """Phase 13's view of the daemons: phase 12's, plus the client's wall
    clock at the first dispatch and each daemon's last chunk completion."""

    def __init__(self):
        super().__init__()
        witness = self
        self.dispatch_t = None

        class Hook(type(self.hook)):
            def on_dispatch_start(self) -> None:
                if witness.dispatch_t is None:
                    witness.dispatch_t = time.time()

        self.hook = Hook()

    def read(self) -> None:
        super().read()
        for gid, bound in self.dp.bound_gateways.items():
            log = _cloud_get(bound.server, "chunk_status_log", include_log=1)["chunk_status_log"]
            done = [r["time"] for r in log if r["state"] == "complete"]
            self.daemons[gid]["last_complete"] = max(done) if done else None


def multicloud_transfer(boto3, chunks, work: Path, new_vm, card: str, device: str) -> dict:
    """Phase 13: one ``pipeline("direct")`` multicast from IBM COS to Azure
    Blob and SCP object storage, its three gateways booted by
    ``SSHServer.start_gateway`` on sandbox VMs that the port's
    ``IBMCloudProvider``, ``AzureCloudProvider`` and ``SCPCloudProvider``
    return."""
    import azure.storage.blob as blob_sdk

    from skyplane_tpu_torch.api.client import SkyplaneClient
    from skyplane_tpu_torch.api.config import TransferConfig
    from skyplane_tpu_torch.compute import bootstrap
    from skyplane_tpu_torch.obj_store.storage_interface import StorageInterface
    from skyplane_tpu_torch.obs import get_recorder

    src = f"cos://{MULTICLOUD_SRC[0]}/{MULTICLOUD_SRC[1]}"
    dsts = (f"azure://{MULTICLOUD_AZURE[0]}/{MULTICLOUD_AZURE[1]}", f"scp://{MULTICLOUD_SCP}")
    boto3.create_bucket_dir(MULTICLOUD_SRC[1], MULTICLOUD_SRC[0])
    boto3.create_bucket_dir(MULTICLOUD_SCP, "kr-west-1")
    ifaces = [StorageInterface.create("cos:infer", "/".join(MULTICLOUD_SRC)),
              StorageInterface.create("azure:infer", "/".join(MULTICLOUD_AZURE)),
              StorageInterface.create("scp:infer", MULTICLOUD_SCP)]
    ifaces[1].create_bucket("azure:infer")
    tags = tuple(i.region_tag() for i in ifaces)
    if tags != MULTICLOUD_TAGS:
        raise AssertionError(f"phase 13: the backends derive region tags {tags}, not {MULTICLOUD_TAGS}")
    s3 = boto3.client("s3", region_name=MULTICLOUD_SRC[0])
    objects = {f"snapshots/obj{i}.bin": b"".join(chunks[i * CLOUD_OBJECT_CHUNKS:(i + 1) * CLOUD_OBJECT_CHUNKS])
               for i in range(MULTICLOUD_OBJECTS)}
    for key, blob in objects.items():
        s3.put_object(Bucket=MULTICLOUD_SRC[1], Key=key, Body=blob)
    raw = sum(len(b) for b in objects.values())

    names = {"cos": "vm_ibm", "azure": "vm_azure", "scp": "vm_scp"}

    def provision(region_tag: str):
        return new_vm(names[region_tag.split(":")[0]], region_tag)

    part_mb = len(chunks[0]) >> 20
    cfg = TransferConfig(compress="tpu", dedup=True, auto_codec_decision=False, encrypt_e2e=False,
                         encrypt_socket_tls=False, multipart_threshold_mb=2 * part_mb, multipart_chunk_size_mb=part_mb)
    log(f"phase 13: {len(objects)} objects of {len(next(iter(objects.values())))} bytes from {src} ({tags[0]}) to "
        f"{dsts[0]} ({tags[1]}) and {dsts[1]} ({tags[2]}) in one multicast, parts of {part_mb} MiB (the corpus's "
        f"first two snapshots: phase 12's 6 objects cut to {MULTICLOUD_OBJECTS} to keep the script inside its time "
        "limit); TransferConfig(compress='tpu', dedup=True, auto_codec_decision=False, encrypt_e2e=False, "
        "encrypt_socket_tls=False); SKYPLANE_TPU_PARANOID_VERIFY=1 on the VMs")
    client = SkyplaneClient(transfer_config=cfg, log_dir=str(work / "client_log"))
    util = cloud_util()
    # the provisioner asks a gateway's provider by its region tag's prefix: the
    # COS region's gateway is an IBM Cloud VM (get_cloud_provider has no "cos"
    # branch, in the JAX package either)
    for prefix, provider in (("cos", "ibmcloud"), ("azure", "azure"), ("scp", "scp")):
        client.provisioner._providers[prefix] = util.make_sandbox_provider(provider, provision)
    pipe = client.pipeline(planning_algorithm="direct")
    pipe.queue_copy(src + "/", [d + "/" for d in dsts], recursive=True)
    witness = MulticloudWitness()
    create_dataplane = pipe.create_dataplane

    def keep_dataplane(debug: bool = False):
        witness.dp = create_dataplane(debug)
        return witness.dp

    pipe.create_dataplane = keep_dataplane
    rec = get_recorder()
    since = rec.seq()
    boto3.calls.clear()
    blob_sdk.calls.clear()
    t0 = time.perf_counter()
    stats = pipe.start(hooks=witness.hook)
    wall = time.perf_counter() - t0
    split, by_kind = client_split(rec.events_since(since))
    gbps = raw * 8 / split["transfer"] / 1e9 if split["transfer"] else float("nan")
    log(f"phase 13 on {card}: pipe.start() wall {wall:.3f} s: " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
        + " (provision is the three sandbox VMs' boot: venv, install and daemon each); by phase: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(by_kind.items()))
        + f"; {raw} raw bytes to each destination, {gbps:.4f} Gbps over the transfer stage; tracker transfer_stats {stats}")

    # every object at both destinations byte-identical to its source
    azure_iface = StorageInterface.create("azure:infer", "/".join(MULTICLOUD_AZURE))
    got = {"azure": {o.key: o.size for o in azure_iface.list_objects()},
           "scp": {o["Key"]: o["Size"] for page in s3.get_paginator("list_objects_v2").paginate(Bucket=MULTICLOUD_SCP)
                   for o in page.get("Contents", [])}}
    for name, listed in got.items():
        if sorted(listed) != sorted(objects):
            raise AssertionError(f"phase 13: the {name} destination holds {sorted(listed)}, not {sorted(objects)}")
    for key, blob in objects.items():
        out = work / "readback.bin"
        azure_iface.download_object(key, out)
        at_scp = s3.get_object(Bucket=MULTICLOUD_SCP, Key=key)["Body"].read()
        for name, data in (("azure", out.read_bytes()), ("scp", at_scp)):
            if hashlib.sha256(data).digest() != hashlib.sha256(blob).digest():
                raise AssertionError(f"phase 13: {key} at the {name} destination differs from its source")
    # every Azure object committed from 4 staged blocks, every SCP object a 4-part upload
    commits = sorted(len(kw["block_ids"]) for op, kw in blob_sdk.calls
                     if op == "commit_block_list" and kw["container"] == MULTICLOUD_AZURE[1])
    staged = sum(1 for op, kw in blob_sdk.calls if op == "stage_block")
    completes = sorted(len(kw["MultipartUpload"]["Parts"]) for op, kw in boto3.calls
                       if op == "complete_multipart_upload" and kw["Bucket"] == MULTICLOUD_SCP)
    want = [CLOUD_OBJECT_CHUNKS] * len(objects)
    if commits != want or completes != want:
        raise AssertionError(f"phase 13: Azure commits of {commits} blocks and SCP uploads of {completes} parts, not "
                             f"{len(objects)} of {CLOUD_OBJECT_CHUNKS} each")
    log(f"phase 13: all {len(objects)} objects sha256-identical to their sources at both destinations; Azure: "
        f"{len(commits)} blobs each committed from {commits[0]} staged blocks (the client process saw {staged} "
        f"stage_block calls: the destination daemon staged them); SCP: {len(completes)} multipart uploads of "
        f"{completes[0]} parts each")

    if len(witness.daemons) != 3:
        raise AssertionError(f"phase 13: the hook saw {len(witness.daemons)} daemons, not 3")
    launches, per_dst = {}, {}
    for gid, d in witness.daemons.items():
        vm, builds, prof = d["vm"], d["builds"], d["profile"]
        log(f"phase 13: daemon {gid} on {vm.instance_id} ({d['region']}, pids {d['pids']}, device "
            f"{builds['device']!r}): kernel launches {d['kernels']}; phase.first_compile {d['first_compile']} s; runner "
            f"windows {prof.get('batch_windows')}, raw bytes {prof.get('raw_bytes')}, wire bytes {prof.get('wire_bytes')}, "
            f"segments {prof.get('segments')}, REF {prof.get('ref_segments')}")
        for name, b in sorted(builds["builds"].items()):
            log(f"phase 13: {vm.instance_id} built {name} in {b['seconds']:.3f} s into {b['path']} from {b['source']}")
        if d["errors"]:
            raise AssertionError(f"phase 13: daemon {gid} reports errors: {d['errors'][0][:2000]}")
        if builds["device"] != device:
            raise AssertionError(f"phase 13: daemon {gid} is on {builds['device']!r}, not {device!r}")
        is_src = d["region"] == MULTICLOUD_TAGS[0]
        if not is_src:
            if d["last_complete"] is None or witness.dispatch_t is None:
                raise AssertionError(f"phase 13: destination daemon {gid} logged no completion")
            per_dst[d["region"]] = raw * 8 / (d["last_complete"] - witness.dispatch_t) / 1e9
        if device != "cpu":
            for name in ("gear_compact", "segment_fp") if is_src else ("segment_fp",):
                if d["kernels"].get(name, 0) <= 0:
                    raise AssertionError(f"phase 13: daemon {gid} ({d['region']}) launched no {name}: {d['kernels']}")
                b = builds["builds"].get(name)
                root_build, venv = vm.remote(bootstrap.REMOTE_BUILD_DIR), vm.remote(bootstrap.REMOTE_VENV)
                if b is None or Path(b["path"]).parent != root_build or not b["source"].startswith(str(venv)):
                    raise AssertionError(f"phase 13: {name} of daemon {gid} was not built from the wheel's source "
                                         f"under the VM's root: {b}")
        for name, n in d["kernels"].items():
            launches[name] = launches.get(name, 0) + n
    log("phase 13: Gbps by destination, raw bytes over the client's first dispatch to the destination daemon's last "
        "chunk completion: " + ", ".join(f"{tag} {v:.4f}" for tag, v in sorted(per_dst.items())))
    left = [vm.instance_id for vm in (d["vm"] for d in witness.daemons.values()) if vm.daemon_pids()]
    if left:
        raise AssertionError(f"phase 13: daemons of {left} outlived deprovisioning")
    log(f"phase 13: the three daemons gone after deprovisioning; launches on the multicast (all three daemons) {launches}")
    return {"wall_s": wall, "split": split, "gbps": gbps, "gbps_by_destination": per_dst, "launches": launches}


def multicloud_phase(chunks, card: str, device: str, preinstalled: bool = False) -> dict:
    """Phase 13 (see the module docstring): the sandbox VMs, the SDK
    stand-ins and the providers' settings around ``multicloud_transfer``.
    ``preinstalled`` VMs skip the wheel (the CPU rehearsal's fast boot)."""
    import tempfile

    from skyplane_tpu_torch.compute import bootstrap

    util = cloud_util()
    t0 = time.perf_counter()
    wheel = dict(bootstrap.wheel_info)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_multicloud_"))  # outside the checkout, as a VM's home is
    sdk, store = work / "sdk", work / "store"
    saved = {k: os.environ.get(k) for k in (*MULTICLOUD_ENV, "SKYPLANE_TPU_BOOTSTRAP_PIP_ARGS", "SCP_CREDENTIAL_FILE",
                                           "IBM_CONFIG_FILE")}
    os.environ["SKYPLANE_TPU_BOOTSTRAP_PIP_ARGS"] = "--no-deps"  # no package index on the VMs
    os.environ["SCP_CREDENTIAL_FILE"] = str(work / "no_scp_credential")
    os.environ["IBM_CONFIG_FILE"] = str(work / "no_ibm_credentials")
    for k, v in MULTICLOUD_ENV.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    vm_env = {util.FAKE_S3_ROOT_ENV: str(store), "SKYPLANE_TPU_PARANOID_VERIFY": "1"}
    if device == "cpu":
        vm_env["SKYPLANE_GATEWAY_DEVICE"] = "cpu"
    vms = []

    def new_vm(name: str, region_tag: str):
        vm = util.SandboxVM(work / name, region_tag=region_tag, instance_id=f"sandbox-{name}", env=vm_env,
                            extra_path=[str(sdk)], preinstalled=preinstalled)
        vms.append(vm)
        return vm

    try:
        with util.fake_sdk_modules(sdk, store, also=MULTICLOUD_MODULES) as boto3:
            log(f"phase 13: sandbox VMs under {work} (PYTHONPATH: torch's site-packages and the boto3, ibm_boto3 and "
                f"azure stand-ins {sdk}), buckets and containers in {store}; "
                + (f"the VMs install phase 12's wheel {wheel.get('path')}" if not preinstalled else "preinstalled VMs"))
            transfer = multicloud_transfer(boto3, chunks, work, new_vm, card, device)
        if not preinstalled:
            if bootstrap.wheel_info != wheel or not wheel:
                raise AssertionError(f"phase 13: the wheel was rebuilt ({wheel} -> {bootstrap.wheel_info})")
            name = Path(wheel["path"]).name
            for vm in vms:
                # one boot's installs (the wheel with its extra, then the package forced)
                per_boot = sum("pip install" in c for c in bootstrap.venv_bootstrap_commands(vm.region_tag))
                installs = [c for c in vm.commands if "pip install" in c]
                if len(installs) != per_boot or not all(name in c for c in installs):
                    raise AssertionError(f"phase 13: {vm.instance_id} did not boot once from phase 12's wheel {name}: "
                                         f"{installs}")
            log(f"phase 13: each VM booted once from phase 12's wheel {name} (not rebuilt); start_gateway command "
                "seconds by VM: " + ", ".join(f"{vm.instance_id} {_vm_command_seconds(vm)}" for vm in vms))
    except BaseException:
        for vm in vms:
            log(f"phase 13: {vm.instance_id}'s daemon log, its last 6000 characters:\n{vm.daemon_log()[-6000:]}")
        raise
    finally:
        for vm in vms:
            vm.stop_daemon()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")
    return transfer


# ---- phase 14: the port's static analysis (slice 16) ----

LINT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_lint"  # gitignored, inside the checkout
LINT_BOUND_S = 30.0  # the cold pass's bound, as the tier-1 gate holds it


def lint_phase(card: str) -> dict:
    """Phase 14: the port's lint over ``skyplane_tpu_torch`` through its CLI,
    cold then warm, and phase 12's wheel holding the analysis package."""
    from skyplane_tpu_torch.compute import bootstrap

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    shutil.rmtree(LINT_DIR, ignore_errors=True)
    LINT_DIR.mkdir(parents=True)
    env = {**os.environ, "SKYPLANE_TPU_SKLINT_CACHE": str(LINT_DIR / "sklint-cache.json")}
    cli = [sys.executable, "-m", "skyplane_tpu_torch.cli.cli", "lint"]
    listed = subprocess.run(cli + ["--list-rules"], cwd=root, env=env, capture_output=True, text=True, timeout=120)
    if listed.returncode != 0:
        raise AssertionError(f"phase 14: lint --list-rules exited {listed.returncode}:\n{listed.stderr[-4000:]}")
    rules = sorted(line.split()[0] for line in listed.stdout.splitlines() if line.strip())
    runs = {}
    for label in ("cold", "warm"):
        out = LINT_DIR / f"report-{label}.json"
        t0 = time.perf_counter()
        r = subprocess.run(cli + ["skyplane_tpu_torch", "--json", str(out)], cwd=root, env=env,
                           capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"phase 14: lint ({label}) exited {r.returncode}:\n{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
        report = json.loads(out.read_text())
        runs[label] = {"wall_s": wall, "pass_s": report["wall_time_s"], "report": report}
        log(f"phase 14 on {card}: lint ({label}) {report['files_checked']} files, process wall {wall:.3f} s, pass "
            f"{report['wall_time_s']:.3f} s, cache {report['cache']}; its summary: {r.stderr.strip().splitlines()[-1]}")
    cold, warm = runs["cold"]["report"], runs["warm"]["report"]
    by_rule = {k: v for k, v in cold["rule_counts"].items() if v["total"]}
    log(f"phase 14: findings by rule (total / unsuppressed): "
        + ", ".join(f"{k} {v['total']}/{v['unsuppressed']}" for k, v in sorted(by_rule.items()))
        + f"; {cold['n_findings']} findings, {cold['n_unsuppressed']} unsuppressed, {len(rules)} rules")
    for label, report in (("cold", cold), ("warm", warm)):
        if report["n_unsuppressed"] or not report["ok"]:
            raise AssertionError(f"phase 14: lint ({label}) has {report['n_unsuppressed']} unsuppressed findings")
        if report["files_checked"] <= 100:
            raise AssertionError(f"phase 14: lint ({label}) checked {report['files_checked']} files, not more than 100")
        if sorted(report["rule_counts"]) != rules:
            raise AssertionError(f"phase 14: rule_counts {sorted(report['rule_counts'])} are not --list-rules {rules}")
    if runs["cold"]["wall_s"] >= LINT_BOUND_S:
        raise AssertionError(f"phase 14: the cold lint took {runs['cold']['wall_s']:.3f} s, not under {LINT_BOUND_S} s")
    if cold["cache"].get("full_hit") or cold["cache"].get("files_reused"):
        raise AssertionError(f"phase 14: the cold lint hit a cache: {cold['cache']}")
    if not warm["cache"].get("full_hit") or warm["findings"] != cold["findings"]:
        raise AssertionError(f"phase 14: the warm lint was not a full hit of the same findings: {warm['cache']}")
    wheel = dict(bootstrap.wheel_info)
    names = set(bootstrap.wheel_listing())
    if not wheel or bootstrap.wheel_info != wheel:
        raise AssertionError(f"phase 14: phase 12's wheel was not there to list ({wheel} -> {bootstrap.wheel_info})")
    wanted = {f"skyplane_tpu_torch/analysis/{f.name}" for f in (root / "skyplane_tpu_torch" / "analysis").glob("*.py")}
    if len(wanted) < 15 or not wanted <= names:
        raise AssertionError(f"phase 14: the wheel lacks {sorted(wanted - names)} of the analysis package")
    log(f"phase 14: phase 12's wheel {Path(wheel['path']).name} lists all {len(wanted)} files of skyplane_tpu_torch/analysis/")
    shutil.rmtree(LINT_DIR, ignore_errors=True)
    log(f"phase 14 on {card}: {time.perf_counter() - t_phase:.1f} s")
    return {k: {"wall_s": v["wall_s"], "pass_s": v["pass_s"]} for k, v in runs.items()}


def device_busy(events):
    """Device events of a profile -> (busy us: the union of their intervals,
    the 8 names with the most device time, as (name, us))."""
    from collections import defaultdict

    busy_us, end_us = 0.0, None
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if end_us is None or start > end_us:
            busy_us += stop - start
            end_us = stop
        elif stop > end_us:
            busy_us += stop - end_us
            end_us = stop
    by_name = defaultdict(float)
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us()
    return busy_us, sorted(by_name.items(), key=lambda kv: -kv[1])[:8]


def profile_main_path(dev, chunks, params, card: str) -> None:
    """Phase 4: one more pass of the main path (fresh runner and index) under
    torch.profiler: the device's busy share of the wall time (the union of
    its kernel and copy intervals) and device time by kernel or copy name.
    Only the profiler's own failures (it cannot start, or records no device
    activity) are reported as not measured; an error of the data path ends
    the run."""
    from torch.profiler import ProfilerActivity, profile

    from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner
    from skyplane_tpu_torch.ops.dedup import SenderDedupIndex
    from skyplane_tpu_torch.ops.pipeline import DataPathProcessor

    runner = DeviceBatchRunner(cdc_params=params, max_batch=MAX_BATCH, device=dev)
    proc = DataPathProcessor(codec_name="tpu", dedup=True, cdc_params=params, batch_runner=runner, device=dev)
    index = SenderDedupIndex()
    lock = threading.Lock()

    def one(c: bytes) -> None:
        p = proc.process(c, index)
        with lock:
            for fp, size in p.new_fingerprints:
                index.add(fp, size)

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as err:  # noqa: BLE001 — the profiler, not the port
        log(f"phase 4: device busy share not measured (profiler did not start: {err!r})")
        prof = None
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=WORKERS) as pool:
            list(pool.map(one, chunks))
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.stop()
    if prof is None:
        return
    try:
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as err:  # noqa: BLE001 — the profiler, not the port
        events, why = [], f"profiler events unreadable: {err!r}"
    else:
        why = "no device events traced"
    if not events:
        log(f"phase 4 on {card}: profiled wall {wall:.3f} s; device busy share not measured ({why})")
        return
    busy_us, top = device_busy(events)
    log(f"phase 4 on {card}: profiled wall {wall:.3f} s, device busy {busy_us / 1e3:.3f} ms = "
        f"{busy_us / 1e6 / wall:.2%} of wall (idle {1 - busy_us / 1e6 / wall:.2%}); device time by name (ms): "
        + "; ".join(f"{name[:60]} {us / 1e3:.3f}" for name, us in top))
    per_kernel = {k: [e.time_range.elapsed_us() for e in events if f"{k}_kernel" in e.name] for k in SLICE1}
    log("phase 4: traced device time of the main path's kernels: " + "; ".join(
        f"{k} {sum(v) / 1e3:.4f} ms over {len(v)} launches" for k, v in per_kernel.items()))


def batch_step(dev, chunks, card: str):
    """Phase 5: ``datapath_step`` on the card, its checks, and its kernels
    against their plain versions. Returns (launches, errors, timings, bounds)."""
    from skyplane_tpu_torch.ops import kernels
    from skyplane_tpu_torch.ops.fingerprint import MAX_SEGMENT_BYTES, N_LANES
    from skyplane_tpu_torch.ops.host_fallback import blockpack_decode_host
    from skyplane_tpu_torch.ops.pipeline import datapath_step
    from skyplane_tpu_torch.ops.u32 import M31
    from skyplane_tpu_torch.state import device_tables

    tables = device_tables(dev)
    bucket = CHUNK_MB << 20
    rows = np.stack([np.frombuffer(c, np.uint8) for c in chunks[:MAX_BATCH]])
    batch = torch.from_numpy(rows).to(dev)
    step = dict(block_bytes=STEP_BLOCK, fp_seg_bytes=STEP_FP_SEG, mask_bits=STEP_MASK_BITS)

    sync(dev)
    kernels.reset_launch_counts()
    out = datapath_step(batch, **step)
    sync(dev)
    launches = kernels.launch_counts()
    log(f"phase 5: datapath_step B={MAX_BATCH} N={bucket} {step}: kernel launches {launches}")
    if any(launches[k] == 0 for k in SLICE2):
        raise AssertionError(f"a kernel of the batch step never launched: {launches}")

    # the entry() twin on the card equals its CPU run (plain versions)
    from skyplane_tpu_torch.entry import entry

    fn, args = entry()
    fn_cpu, args_cpu = entry(device="cpu")
    got, want = fn(*args), fn_cpu(*args_cpu)
    entry_err = max(max_abs_err(got[k].cpu(), want[k]) for k in want)
    if entry_err:
        raise AssertionError(f"entry() on the card differs from its CPU run by {entry_err}")

    # the outputs: shapes, types, ranges, and every row's literals round trip
    want_shapes = {
        "candidates": ((MAX_BATCH, bucket), torch.bool),
        "tags": ((MAX_BATCH, bucket // STEP_BLOCK), torch.uint8),
        "literals": ((MAX_BATCH, bucket), torch.uint8),
        "n_lit": ((MAX_BATCH,), torch.int32),
        "fp_lanes": ((MAX_BATCH, bucket // STEP_FP_SEG, N_LANES), torch.int32),
    }
    for k, (shape, dtype) in want_shapes.items():
        if tuple(out[k].shape) != shape or out[k].dtype != dtype or out[k].device != batch.device:
            raise AssertionError(f"{k}: {out[k].dtype} {tuple(out[k].shape)} on {out[k].device}, want {dtype} {shape}")
    lanes = out["fp_lanes"]
    if int(lanes.min()) < 0 or int(lanes.max()) >= M31:
        raise AssertionError("fp_lanes outside [0, M31)")
    tags_np, lit, n_lit = out["tags"].cpu().numpy(), out["literals"].cpu(), out["n_lit"].cpu().numpy()
    for i in range(MAX_BATCH):
        if not 0 <= n_lit[i] <= bucket or lit[i, n_lit[i]:].any():
            raise AssertionError(f"row {i}: n_lit {n_lit[i]} or a nonzero literal tail")
        back = blockpack_decode_host(tags_np[i], lit[i, : n_lit[i]].numpy(), STEP_BLOCK)
        if not np.array_equal(back, rows[i]):
            raise AssertionError(f"row {i}: literals do not decode to the row")
    tag_counts = np.bincount(tags_np.reshape(-1), minlength=3).tolist()
    n_cand = int(out["candidates"].sum())
    log(f"phase 5: entry() twin on the card equals its CPU run; outputs checked; all {MAX_BATCH} rows decode byte-identical from (tags, literals[:n_lit]); "
        f"tags zero/const/literal {tag_counts}; literal bytes {int(n_lit.sum())} of {MAX_BATCH * bucket}; candidates {n_cand}")

    # each kernel == its plain version: the step's rows, then adversarial rows
    rng = np.random.default_rng(2)
    adv = rows.copy()
    adv[4] = 0
    adv[5] = 0x5A
    adv[6] = np.tile(rng.integers(0, 256, 1024, dtype=np.uint8), bucket // 1024)
    adv[7] = rng.integers(0, 256, bucket, dtype=np.uint8)
    adv_batch = torch.from_numpy(adv).to(dev)
    errs = {k: 0 for k in SLICE2}
    for b in (batch, adv_batch):
        errs["gear_mask"] = max(errs["gear_mask"], max_abs_err(
            kernels.gear_mask(b, tables, STEP_MASK_BITS), kernels.gear_mask_plain(b, tables, STEP_MASK_BITS)))
        errs["segment_fp_fixed"] = max(errs["segment_fp_fixed"], max_abs_err(
            kernels.segment_fp_fixed(b, STEP_FP_SEG, tables), kernels.segment_fp_fixed_plain(b, STEP_FP_SEG, tables)))
        got, want = kernels.blockpack_encode(b, STEP_BLOCK), kernels.blockpack_encode_plain(b, STEP_BLOCK)
        errs["blockpack_encode"] = max([errs["blockpack_encode"]] + [max_abs_err(g, w) for g, w in zip(got, want)])
        torch.cuda.empty_cache()
    adv_tags = np.bincount(kernels.blockpack_encode(adv_batch, STEP_BLOCK)[0].cpu().numpy().reshape(-1), minlength=3)
    block_errs = {}
    for bb in STEP_EXTRA_BLOCKS:
        cut = batch[:, : bucket // bb * bb].contiguous()
        got, want = kernels.blockpack_encode(cut, bb), kernels.blockpack_encode_plain(cut, bb)
        block_errs[bb] = max(max_abs_err(g, w) for g, w in zip(got, want))
        del cut, got, want
        torch.cuda.empty_cache()
    flat = torch.empty(batch.numel() + 1, dtype=torch.uint8, device=dev)
    shifted = flat[1:].view(batch.shape)  # a contiguous batch at storage offset 1: no bulk copies
    shifted.copy_(batch)
    got, want = kernels.blockpack_encode(shifted, STEP_BLOCK), kernels.blockpack_encode_plain(batch, STEP_BLOCK)
    block_errs["unaligned"] = max(max_abs_err(g, w) for g, w in zip(got, want))
    del flat, shifted, got, want
    torch.cuda.empty_cache()
    errs["blockpack_encode"] = max([errs["blockpack_encode"]] + list(block_errs.values()))
    stride_errs = {}
    for seg in STEP_EXTRA_STRIDES:
        stride_errs[seg] = max_abs_err(kernels.segment_fp_fixed(batch, seg, tables), kernels.segment_fp_fixed_plain(batch, seg, tables))
        torch.cuda.empty_cache()
    odd = batch[:, : (bucket // STEP_ODD_STRIDE // 8) * 8 * STEP_ODD_STRIDE].contiguous()
    stride_errs[STEP_ODD_STRIDE] = max_abs_err(
        kernels.segment_fp_fixed(odd, STEP_ODD_STRIDE, tables), kernels.segment_fp_fixed_plain(odd, STEP_ODD_STRIDE, tables))
    del odd
    torch.cuda.empty_cache()
    errs["segment_fp_fixed"] = max([errs["segment_fp_fixed"]] + list(stride_errs.values()))
    sync(dev)
    log(f"phase 5: max |kernel - plain| {errs} (step rows and adversarial rows: zero, constant 0x5A, "
        f"repeated 1 KiB, random; their tags zero/const/literal {adv_tags.tolist()}); "
        f"segment_fp_fixed at strides {list(STEP_EXTRA_STRIDES)} and {STEP_ODD_STRIDE} (byte path): {stride_errs}; "
        f"blockpack_encode at blocks {list(STEP_EXTRA_BLOCKS)} and on a batch at storage offset 1: {block_errs}")
    if any(errs.values()) or min(adv_tags) == 0:
        raise AssertionError(f"a batch-step kernel disagrees with its plain version: {errs}, tags {adv_tags.tolist()}")

    # times at the step's shapes; the plain versions are the same arithmetic, no yardstick of speed
    t = {
        "gear_mask": (
            time_ms(lambda: kernels.gear_mask(batch, tables, STEP_MASK_BITS), 50),
            time_ms(lambda: kernels.gear_mask_plain(batch, tables, STEP_MASK_BITS), 3, 1),
        ),
        "segment_fp_fixed": (
            time_ms(lambda: kernels.segment_fp_fixed(batch, STEP_FP_SEG, tables), 50),
            time_ms(lambda: kernels.segment_fp_fixed_plain(batch, STEP_FP_SEG, tables), 3, 1),
        ),
        "blockpack_encode": (
            time_ms(lambda: kernels.blockpack_encode(batch, STEP_BLOCK), 50),
            time_ms(lambda: kernels.blockpack_encode_plain(batch, STEP_BLOCK), 3, 1),
        ),
    }
    torch.cuda.empty_cache()
    stride_ms = {seg: time_ms(lambda: kernels.segment_fp_fixed(batch, seg, tables), 20) for seg in STEP_EXTRA_STRIDES}
    encode_traced = traced_ms(lambda: kernels.blockpack_encode(batch, STEP_BLOCK), "blockpack_encode", 50)
    copy_out = torch.empty_like(batch)
    copy_ms = time_ms(lambda: copy_out.copy_(batch), 50)  # a yardstick: one read and one write of the batch
    del copy_out
    block_ms = {}
    for bb in STEP_EXTRA_BLOCKS:
        cut = batch[:, : bucket // bb * bb].contiguous()
        block_ms[bb] = time_ms(lambda: kernels.blockpack_encode(cut, bb), 20)
        del cut
    torch.cuda.empty_cache()
    step_ms = time_ms(lambda: datapath_step(batch, **step), 20)
    n_in = MAX_BATCH * bucket
    bounds = {
        # read the bytes and the table, write one byte per byte. Per byte: the
        # hash step (one shift-add) and the top-bits test
        "gear_mask": bound_ms(n_in + 1024 + n_in, 2 * n_in),
        # read the bytes, word_limbs and the word_powers rows r^(S-64(k+1))
        # (one per word of a segment), write the lanes. Per word with a
        # nonzero byte: its u8 product and 18 integer instructions a lane
        "segment_fp_fixed": bound_ms(
            n_in + 64 * 32 + 32 * (min(STEP_FP_SEG, MAX_SEGMENT_BYTES) // 64) + 4 * lanes.numel(), *word_work(batch)
        ),
        # read the bytes; write tags, literals (the zero tail too) and n_lit.
        # Per byte: one compare with the block's first
        "blockpack_encode": bound_ms(n_in + out["tags"].numel() + n_in + 4 * MAX_BATCH, n_in),
    }
    for name, (ms, plain_ms) in t.items():
        b, by = bounds[name]
        log(f"  {name}: {ms:.4f} ms/launch (plain {plain_ms:.3f} ms), bound {b:.4f} ms ({by}), {b / ms:.1%} of bound")
    log("  segment_fp_fixed at other strides: " + ", ".join(f"S={seg} {ms:.4f} ms" for seg, ms in stride_ms.items()))
    log(f"  blockpack_encode traced: {encode_traced}; a device-to-device copy of the same {n_in} bytes "
        f"(torch.Tensor.copy_, the byte floor of one read and one write): {copy_ms:.4f} ms; on {card}")
    log("  blockpack_encode at other blocks (rows cut to a multiple): "
        + ", ".join(f"bb={bb} {ms:.4f} ms" for bb, ms in block_ms.items()))
    log(f"phase 5 on {card}: datapath_step {step_ms:.4f} ms per call at B={MAX_BATCH} x {bucket} "
        f"= {n_in / step_ms / 1e6:.2f} GB/s of input")
    profile_step(batch, step, card)
    return launches, errs, t, bounds


def profile_step(batch, step: dict, card: str, reps: int = 20) -> None:
    """Phase 5's trace: ``reps`` steps back to back under torch.profiler; the
    device's busy share of their wall time and device time by kernel. Only
    the profiler's own failures read "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    from skyplane_tpu_torch.ops.pipeline import datapath_step

    datapath_step(batch, **step)
    sync(batch.device)
    try:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    except Exception as err:  # noqa: BLE001 — the profiler, not the port
        log(f"phase 5: step trace not measured (profiler did not start: {err!r})")
        return
    try:
        t0 = time.perf_counter()
        for _ in range(reps):
            datapath_step(batch, **step)
        sync(batch.device)
        wall = time.perf_counter() - t0
    finally:
        prof.stop()
    try:
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as err:  # noqa: BLE001 — the profiler, not the port
        log(f"phase 5: step trace not measured (profiler events unreadable: {err!r})")
        return
    if not events:
        log(f"phase 5: step trace not measured (no device events traced; wall {wall * 1e3 / reps:.4f} ms per step)")
        return
    busy_us, top = device_busy(events)
    log(f"phase 5 on {card}: {reps} steps traced, wall {wall * 1e3 / reps:.4f} ms per step, device busy "
        f"{busy_us / 1e3 / reps:.4f} ms per step = {busy_us / 1e6 / wall:.2%} of wall (idle {1 - busy_us / 1e6 / wall:.2%}); "
        "device time per step by name (ms): " + "; ".join(f"{name[:60]} {us / 1e3 / reps:.4f}" for name, us in top))


def check_builds(kernels) -> None:
    """Phase 1: registers and spills per kernel function from each library's
    ptxas log, and the fingerprint kernels' integer mma instructions (IMMA) in
    their SASS; a fingerprint kernel without one fails."""
    import re
    import shutil

    for name in kernels._KERNELS:
        lib = kernels.library_path(name)
        log_text = lib.with_name(lib.name + ".log").read_text() if lib.with_name(lib.name + ".log").exists() else ""
        regs = re.findall(r"Used (\d+) registers", log_text)
        spills = re.findall(r"(\d+) bytes spill stores", log_text)
        smem = re.findall(r"(\d+) bytes smem", log_text)
        line = f"phase 1: {name}: registers per function {regs}, spill store bytes {spills}, shared memory bytes {smem}"
        if name in ("segment_fp", "segment_fp_fixed"):
            tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
            try:
                sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120, check=True).stdout
            except (OSError, subprocess.SubprocessError) as err:
                line += f"; SASS not read ({err!r})"
            else:
                imma = len(re.findall(r"\bIMMA\.", sass))
                line += f"; IMMA instructions in its SASS: {imma}"
                if imma == 0:
                    raise AssertionError(f"{name} issues no integer mma instruction")
        log(line)


def build_native() -> bool:
    """Phase 1: build and load the native host library (fails without it:
    the card's machine has g++, nvcc's host compiler); report liblz4.
    Returns whether the lz4 pass can run."""
    from skyplane_tpu_torch import native
    from skyplane_tpu_torch.native import datapath as native_dp
    from skyplane_tpu_torch.utils import lz4ref

    native.load_library()
    if not native_dp.available():
        raise AssertionError("the native host library is not available (SKYPLANE_TPU_NATIVE_DATAPATH opt-out set?)")
    info = native.build_info
    log(f"phase 1: native host library {info['path']}: built in {info['seconds']:.2f} s "
        f"(0.00: found built), -march=native {'took' if info['march_native'] else 'failed: portable build'}")
    if lz4ref.available():
        log("phase 1: lz4ref.available() True (system liblz4)")
    else:
        log("phase 1: lz4ref.available() False: liblz4.so.1 is not present, so the lz4 pass of phase 3 is not measured")
    return lz4ref.available()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from skyplane_tpu_torch.ops import kernels
    from skyplane_tpu_torch.ops.cdc import CDCParams

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"phase 1: device {kind} (count {torch.cuda.device_count()}), torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"phase 1: nvidia-smi: {card}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:  # the host library builds beside the kernels
        host_build = pool.submit(build_native)
        build_s = kernels.build()
        with_lz4 = host_build.result()
    log(f"phase 1: built {sorted(build_s)} in {time.perf_counter() - t0:.2f} s (per kernel: "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(build_s.items())) + ")")
    check_builds(kernels)

    t0 = time.perf_counter()
    chunks = make_corpus(SEED)
    raw_total = sum(len(c) for c in chunks)
    log(f"corpus: {len(chunks)} chunks, {raw_total} bytes, made in {time.perf_counter() - t0:.1f} s")
    params = CDCParams()
    errs, timings, bounds = check_kernels(dev, chunks, params)

    launches, main_gbps = main_path(dev, chunks, params, card, with_lz4)
    profile_main_path(dev, chunks, params, card)
    step_launches, step_errs, step_timings, step_bounds = batch_step(dev, chunks, card)
    gateway_phase(dev, chunks, params, card, main_gbps)
    client = client_phase(chunks, card)
    torch.cuda.empty_cache()  # the daemons of phase 8 (a) are processes of their own
    blast_client_phase(chunks, card)
    blast_heal_phase(dev, chunks, params, card)
    service_phase(dev, chunks, params, card, client["split"]["provision"])
    cli = cli_phase(dev, chunks, params, card)
    torch.cuda.empty_cache()
    spmd = spmd_phase(dev, chunks, params, card)
    torch.cuda.empty_cache()  # the sandbox VMs' daemons of phase 12 are processes of their own
    cloud = cloud_phase(chunks, card, str(dev))
    multicloud = multicloud_phase(chunks, card, str(dev))
    lint_phase(card)
    launches.update({k: step_launches[k] for k in SLICE2})
    errs.update(step_errs)
    timings.update(step_timings)
    bounds.update(step_bounds)

    replaces = {
        # the Pallas gear windowed sum, with the XLA compaction of _candidates_impl
        # (skyplane_tpu/ops/fused_cdc.py:91) fused into the same kernel
        "gear_compact": ("skyplane_tpu_torch/csrc/gear_compact.cu", "skyplane_tpu/ops/pallas_kernels.py:49"),
        "segment_fp": ("skyplane_tpu_torch/csrc/segment_fp.cu", "skyplane_tpu/ops/fused_cdc.py:108"),
        "gear_mask": ("skyplane_tpu_torch/csrc/gear_mask.cu", "skyplane_tpu/ops/pallas_kernels.py:49"),
        "segment_fp_fixed": ("skyplane_tpu_torch/csrc/segment_fp_fixed.cu", "skyplane_tpu/ops/pallas_kernels.py:140"),
        "blockpack_encode": ("skyplane_tpu_torch/csrc/blockpack_encode.cu", "skyplane_tpu/ops/blockpack.py:44"),
        # K-A' in halo mode: the per-shard gear hash of the SPMD step (K8)
        "gear_mask_halo": ("skyplane_tpu_torch/csrc/gear_mask.cu", "skyplane_tpu/parallel/datapath_spmd.py:121"),
    }
    halo = spmd["halo"]
    timings["gear_mask_halo"] = (halo["ms"], halo["plain_ms"])
    bounds["gear_mask_halo"] = (halo["bound_ms"], halo["bound_by"])
    errs["gear_mask_halo"] = halo["max_abs_err"]
    launches["gear_mask_halo"] = spmd["launches"]["gear_mask_halo"]
    rows = []
    for name, (source, rep) in replaces.items():
        ms, plain_ms = timings[name]
        b, by = bounds[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": rep, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": None, "launches_cli": cli["service"]["launches"].get(name, 0),
            "launches_spmd": spmd["launches"][name], "launches_cloud": cloud["launches"].get(name, 0),
            "launches_multicloud": multicloud["launches"].get(name, 0),
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
