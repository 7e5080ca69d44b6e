"""skyplane-tpu CLI: cp, sync, init, deprovision, config, ssh.

Reference parity: skyplane/cli/cli.py:20-105 (Typer app) — implemented with
click (typer is not in this image). Transfer orchestration (path parsing,
fallbacks, confirmation, progress) lives in cli_transfer.py like the
reference's cli_transfer.py:113-423.

The port's copy of the JAX package's command line: the same commands,
options, help and exit codes, over ``skyplane_tpu_torch``. Run it as
``python -m skyplane_tpu_torch.cli.cli`` (or the ``skyplane-tpu-torch``
script). Gateways that ``cp``, ``sync`` and ``blast`` spawn run on the card
unless ``SKYPLANE_LOCAL_GATEWAY_PLATFORM=cpu``. ``lint`` runs the port's
own static analysis (``skyplane_tpu_torch.analysis``).
"""

from __future__ import annotations

import sys

import click

from skyplane_tpu_torch import __version__


@click.group()
@click.version_option(__version__)
def main():
    """skyplane-tpu: TPU-accelerated bulk cloud data transfer."""


@main.command()
@click.argument("src")
@click.argument("dst", nargs=-1, required=True)
@click.option("-r", "--recursive", is_flag=True, help="copy a prefix tree")
@click.option("-y", "--yes", is_flag=True, help="skip confirmation")
@click.option("--max-instances", default=None, type=int, help="gateway VMs per region")
@click.option(
    "--solver", default="direct",
    type=click.Choice(["direct", "src_one_sided", "dst_one_sided", "ron", "ilp", "blast"]),
)
@click.option("--compress", default=None, type=click.Choice(["none", "zstd", "tpu", "tpu_zstd", "native_lz", "lz4"]))
@click.option("--dedup/--no-dedup", default=None, help="content-defined dedup on the TPU path")
@click.option("--resume", is_flag=True, help="journal chunk progress; re-run continues where a killed transfer stopped")
@click.option("--debug", is_flag=True, help="collect gateway logs on exit")
@click.option("--tenant", default=None, help="tenant id (16 hex chars) for multi-tenant gateways; minted when omitted")
def cp(src, dst, recursive, yes, max_instances, solver, compress, dedup, resume, debug, tenant):
    """Copy objects between clouds: skyplane-tpu cp s3://a/ gs://b/ [-r]."""
    from skyplane_tpu_torch.cli.cli_transfer import run_transfer

    sys.exit(run_transfer(src, list(dst), recursive=recursive, sync=False, yes=yes,
                          max_instances=max_instances, solver=solver, compress=compress, dedup=dedup,
                          resume=resume, debug=debug, tenant=tenant))


@main.command()
@click.argument("src")
@click.argument("dst", nargs=-1, required=True)
@click.option("-y", "--yes", is_flag=True, help="skip confirmation")
@click.option("--max-instances", default=None, type=int)
@click.option("--fanout", default=None, type=int, help="max peer-serve out-degree per sink (SKYPLANE_TPU_BLAST_FANOUT)")
@click.option(
    "--source-degree", default=None, type=int,
    help="max tree children of the SOURCE; 1 keeps source egress at ~1x the corpus (SKYPLANE_TPU_BLAST_SOURCE_DEGREE)",
)
@click.option("--compress", default=None, type=click.Choice(["none", "zstd", "tpu", "tpu_zstd", "native_lz", "lz4"]))
@click.option("--dedup/--no-dedup", default=None, help="content-defined dedup per tree edge (warm repeat blasts)")
@click.option("--debug", is_flag=True)
@click.option("--tenant", default=None, help="tenant id (16 hex chars) for multi-tenant gateways; minted when omitted")
def blast(src, dst, yes, max_instances, fanout, source_degree, compress, dedup, debug, tenant):
    """Blast one corpus to MANY destinations over a peered relay tree.

    The planner places a degree-bounded min-cost relay tree over the egress
    grid; destination gateways peer-serve landed chunks to siblings, so
    source egress approaches 1x the corpus regardless of destination count
    (docs/blast.md). Example:

        skyplane-tpu blast s3://ckpts/step900/ gs://eu/ gs://asia/ s3://west/ -y
    """
    import os

    from skyplane_tpu_torch.cli.cli_transfer import run_transfer

    if len(dst) < 2:
        raise click.ClickException("blast needs >= 2 destinations (one destination is a plain `cp`)")
    if fanout is not None:
        os.environ["SKYPLANE_TPU_BLAST_FANOUT"] = str(fanout)
    if source_degree is not None:
        os.environ["SKYPLANE_TPU_BLAST_SOURCE_DEGREE"] = str(source_degree)
    sys.exit(run_transfer(src, list(dst), recursive=True, sync=False, yes=yes,
                          max_instances=max_instances, solver="blast", compress=compress, dedup=dedup,
                          debug=debug, tenant=tenant))


@main.command()
@click.argument("src")
@click.argument("dst", nargs=-1, required=True)
@click.option("-y", "--yes", is_flag=True)
@click.option("--max-instances", default=None, type=int)
@click.option("--solver", default="direct", type=click.Choice(["direct", "src_one_sided", "dst_one_sided", "ron", "ilp"]))
@click.option("--compress", default=None, type=click.Choice(["none", "zstd", "tpu", "tpu_zstd", "native_lz", "lz4"]))
@click.option("--dedup/--no-dedup", default=None)
@click.option("--debug", is_flag=True)
@click.option("--tenant", default=None, help="tenant id (16 hex chars) for multi-tenant gateways; minted when omitted")
@click.option("--watch", is_flag=True, help="continuous sync: re-run the delta on an interval through a running service (docs/service-mode.md)")
@click.option("--interval", default=30.0, type=float, help="with --watch: seconds between delta rounds")
@click.option("--spool", default=None, help="with --watch: spool directory of the running `skyplane-tpu serve` instance")
def sync(src, dst, yes, max_instances, solver, compress, dedup, debug, tenant, watch, interval, spool):
    """Delta-copy only new or changed objects (always recursive).

    With --watch, the delta filter re-runs continuously on a standing fleet:
    the job spec is dropped into a running service's spool directory and the
    service keeps fingerprints warm across rounds (docs/service-mode.md)."""
    from skyplane_tpu_torch.cli.cli_transfer import run_transfer

    if watch:
        import hashlib
        import json
        from pathlib import Path

        if not spool:
            raise click.ClickException(
                "--watch needs --spool DIR pointing at a running `skyplane-tpu serve` "
                "spool (start one first; see docs/service-mode.md)"
            )
        if len(dst) != 1:
            raise click.ClickException("--watch supports exactly one destination")
        spool_dir = Path(spool)
        if not spool_dir.is_dir():
            raise click.ClickException(f"spool directory does not exist: {spool_dir}")
        import os

        key = hashlib.blake2b(f"{src}\x00{dst[0]}".encode(), digest_size=8).hexdigest()
        spec = {"type": "sync_watch", "src": src, "dst": dst[0], "interval_s": interval}
        if tenant:
            spec["tenant_id"] = tenant
        spec_path = spool_dir / f"watch_{key}.json"
        # atomic landing: the serve worker scans the spool every poll tick
        # and quarantines unparseable files — a torn half-written spec would
        # be .rejected'd instead of ever running
        tmp_path = spec_path.with_suffix(".tmp")
        tmp_path.write_text(json.dumps(spec, indent=2))
        os.replace(tmp_path, spec_path)
        click.echo(
            f"queued continuous sync {src} -> {dst[0]} as {spec_path.name} "
            f"(idempotent: re-running this command updates the same watch)"
        )
        return
    sys.exit(run_transfer(src, list(dst), recursive=True, sync=True, yes=yes,
                          max_instances=max_instances, solver=solver, compress=compress, dedup=dedup, debug=debug,
                          tenant=tenant))


@main.command()
@click.option("--wal-dir", required=True, help="WAL/snapshot state directory (survives restarts)")
@click.option("--spool", required=True, help="job-spec spool directory (one JSON file per job)")
@click.option("--source-url", required=True, help="source gateway control URL, e.g. https://10.0.0.5:8081")
@click.option("--sink-url", required=True, help="sink gateway control URL")
@click.option("--token", default=None, help="gateway API bearer token")
@click.option("--tenant", default=None, help="default tenant id for submitted jobs")
@click.option("--chunk-mb", default=4.0, type=float, help="default chunk size (MiB)")
@click.option("--heartbeat-s", default=5.0, type=float, help="admission-TTL heartbeat interval")
@click.option("--poll-s", default=0.1, type=float, help="progress poll interval")
def serve(wal_dir, spool, source_url, sink_url, token, tenant, chunk_mb, heartbeat_s, poll_s):
    """Run the always-on replication service over a standing fleet.

    Adopts the (already running) gateways via /status, recovers in-flight
    jobs from the crash-safe WAL, then serves jobs dropped into the spool
    directory with sub-second warm dispatch. SIGKILL-safe by design: restart
    with the same --wal-dir and nothing is lost (docs/service-mode.md)."""
    from skyplane_tpu_torch.service.worker import run_service

    run_service(
        wal_dir,
        spool,
        source_url=source_url,
        sink_url=sink_url,
        token=token,
        tenant_id=tenant,
        chunk_bytes=int(chunk_mb * (1 << 20)),
        heartbeat_interval_s=heartbeat_s,
        poll_interval_s=poll_s,
    )


@main.command()
@click.option("--non-interactive", is_flag=True, help="skip prompts; detect credentials only")
def init(non_interactive):
    """Interactive cloud-credentials wizard; writes ~/.skyplane_tpu/config."""
    from skyplane_tpu_torch.cli.cli_init import run_init

    sys.exit(run_init(non_interactive))


@main.command()
def deprovision():
    """Terminate all skyplane-tpu gateway VMs across clouds."""
    from skyplane_tpu_torch.cli.cli_cloud import run_deprovision

    sys.exit(run_deprovision())


@main.group()
def cloud():
    """Bucket and VM administration."""


def _run_cloud_cmd(fn, *args):
    from skyplane_tpu_torch.exceptions import SkyplaneTpuException

    try:
        sys.exit(fn(*args))
    except SkyplaneTpuException as e:
        raise click.ClickException(str(e)) from e


@cloud.command("ls")
@click.argument("path")
def cloud_ls(path):
    """List objects: skyplane-tpu cloud ls s3://bucket/prefix"""
    from skyplane_tpu_torch.cli.cli_cloud import run_ls

    _run_cloud_cmd(run_ls, path)


@cloud.command("mb")
@click.argument("path")
@click.option("--region", default=None, help="cloud region for the new bucket (e.g. us-east-1)")
def cloud_mb(path, region):
    """Create a bucket."""
    from skyplane_tpu_torch.cli.cli_cloud import run_mb

    _run_cloud_cmd(run_mb, path, region)


@cloud.command("rm")
@click.argument("path")
@click.option("-r", "--recursive", is_flag=True)
def cloud_rm(path, recursive):
    """Delete objects."""
    from skyplane_tpu_torch.cli.cli_cloud import run_rm

    _run_cloud_cmd(run_rm, path, recursive)


@main.command(context_settings={"ignore_unknown_options": True})
@click.argument("args", nargs=-1, type=click.UNPROCESSED)
def lint(args):
    """Concurrency + tracer-safety lint (same pass the tier-1 gate runs).

    Forwards to `python -m skyplane_tpu_torch.analysis`; try `lint --list-rules`
    or `lint skyplane_tpu_torch --json findings.json`."""
    from skyplane_tpu_torch.analysis.__main__ import main as lint_main

    sys.exit(lint_main(list(args)))


@main.group()
def trace():
    """Chunk-lifecycle tracing (docs/observability.md)."""


@trace.command("export")
@click.option(
    "--url",
    "urls",
    multiple=True,
    help="gateway control URL, e.g. https://10.0.0.5:8081; repeatable — several gateways merge into ONE timeline "
    "(omit for the in-process tracer)",
)
@click.option("-o", "--output", default="trace.json", help="output file (Chrome trace-event JSON)")
@click.option("--token", default=None, help="gateway API bearer token (defaults to none)")
def trace_export(urls, output, token):
    """Export a Chrome trace-event JSON that loads directly in Perfetto.

    With one or more --url options, fetches GET /api/v1/trace from each
    running gateway's control API and merges them into a single multi-process
    timeline (one Perfetto row per gateway — the fleet view,
    docs/observability.md); without any, dumps this process's tracer (useful
    after an in-process harness run with SKYPLANE_TPU_TRACE_SAMPLE set).
    Open the file at https://ui.perfetto.dev or chrome://tracing."""
    import json

    if urls:
        from skyplane_tpu_torch.obs.collector import scrape_trace_once

        payload = scrape_trace_once(list(urls), token=token)
    else:
        from skyplane_tpu_torch.obs import get_tracer

        payload = get_tracer().export()
    events = payload.get("traceEvents", [])
    with open(output, "w") as f:
        json.dump(payload, f)
    if len([e for e in events if e.get("ph") != "M"]) == 0:
        click.echo(
            f"wrote {output} with NO spans — is tracing on? (SKYPLANE_TPU_TRACE_SAMPLE, docs/observability.md)"
        )
    else:
        click.echo(f"wrote {len(events)} events to {output}; open it in https://ui.perfetto.dev")


@main.command()
@click.option("--trace", "trace_path", default=None, help="a (merged) Chrome trace JSON file to attribute")
@click.option("--url", "urls", multiple=True, help="gateway control URL(s) to scrape live instead of --trace")
@click.option("--cpu", "cpu_path", default=None, help="optional JSON file of per-gateway /profile/cpu payloads")
@click.option("--token", default=None, help="gateway API bearer token (defaults to none)")
@click.option("--json", "as_json", is_flag=True, help="print the raw report as JSON")
def bottleneck(trace_path, urls, cpu_path, token, as_json):
    """Per-transfer "where did the time go": aggregate the per-stage latency
    breakdown (frame / send-stall / ack-lag / decode / store / device-wait)
    and per-thread CPU time across gateways (docs/observability.md).

    Feed it a merged trace (`skyplane-tpu trace export --url A --url B`) or
    let it scrape gateways live with --url."""
    import json as json_mod

    from skyplane_tpu_torch.obs.collector import bottleneck_report, format_bottleneck, scrape_trace_once

    cpu_profiles = None
    profile_summaries = None
    if trace_path:
        with open(trace_path) as f:
            trace = json_mod.load(f)
    elif urls:
        from skyplane_tpu_torch.gateway.control_auth import control_session
        from skyplane_tpu_torch.obs.collector import api_base_of

        trace = scrape_trace_once(list(urls), token=token)
        cpu_profiles = {}
        profile_summaries = {}
        for u in urls:
            base = api_base_of(u)
            # the two fetches are independent and each additive: a failed
            # CPU scrape must not shadow a working stacks scrape (or vice
            # versa) — either block alone still improves the report
            try:
                payload = control_session(token).get(f"{base}/profile/cpu", timeout=10).json()
                cpu_profiles[payload.get("gateway_id") or base] = payload
            except Exception:  # noqa: BLE001 — CPU attribution is additive
                pass
            try:
                # core budget (docs/observability.md "Core-time profiling"):
                # old gateways 404, unarmed profilers report zero samples —
                # either way the report simply omits the core-budget block
                stacks = control_session(token).get(f"{base}/profile/stacks", params={"summary": "1"}, timeout=10)
                if stacks.ok:
                    payload = stacks.json()
                    profile_summaries[payload.get("gateway_id") or base] = payload.get("summary")
            except Exception:  # noqa: BLE001 — profiler summary is additive
                pass
    else:
        raise click.ClickException("pass --trace <file> or at least one --url")
    if cpu_path:
        with open(cpu_path) as f:
            cpu_profiles = json_mod.load(f)
    report = bottleneck_report(trace, cpu_profiles, profile_summaries)
    if report["n_spans"] == 0:
        raise click.ClickException(
            "trace holds no spans — was SKYPLANE_TPU_TRACE_SAMPLE set on the gateways? (docs/observability.md)"
        )
    click.echo(json_mod.dumps(report, indent=2) if as_json else format_bottleneck(report))


@main.command()
@click.option("--url", "urls", multiple=True, help="gateway control URL(s) to scrape live; repeatable")
@click.option("--trace", "trace_path", default=None, help="a saved /api/v1/profile/stacks payload JSON instead of --url")
@click.option("--token", default=None, help="gateway API bearer token (defaults to none)")
@click.option("-o", "--output", default=None, help="write speedscope JSON here (open at https://www.speedscope.app)")
@click.option("--top", default=12, type=int, help="hottest folded stacks to print per gateway")
def flame(urls, trace_path, token, output, top):
    """Core-time flame view: pull each gateway's sampling-profiler stacks
    (GET /api/v1/profile/stacks, SKYPLANE_TPU_PROFILE_HZ > 0), print the
    core-budget verdict plus the hottest folded stacks, and optionally write
    a speedscope JSON (docs/observability.md "Core-time profiling")."""
    import json as json_mod

    from skyplane_tpu_torch.obs.collector import core_budget

    payloads = []
    if trace_path:
        with open(trace_path) as f:
            payload = json_mod.load(f)
        payloads.append((payload.get("gateway_id") or trace_path, payload))
    elif urls:
        from skyplane_tpu_torch.gateway.control_auth import control_session
        from skyplane_tpu_torch.obs.collector import api_base_of

        for u in urls:
            base = api_base_of(u)
            resp = control_session(token).get(f"{base}/profile/stacks", timeout=30)
            if resp.status_code == 404:
                click.echo(f"{base}: no /profile/stacks route (older gateway) — skipping")
                continue
            resp.raise_for_status()
            payload = resp.json()
            payloads.append((payload.get("gateway_id") or base, payload))
    else:
        raise click.ClickException("pass --trace <file> or at least one --url")
    if not payloads:
        raise click.ClickException("no profile payloads collected")
    merged_profiles: list = []
    merged_frames: list = []
    for gw, payload in payloads:
        summary = payload.get("summary") or {}
        if not summary.get("enabled"):
            click.echo(f"gateway {gw}: profiler OFF (set SKYPLANE_TPU_PROFILE_HZ on the gateway)")
            continue
        budget = core_budget(summary)
        if budget is None:
            click.echo(f"gateway {gw}: profiler armed but no samples yet")
            continue
        verdict = "YES" if budget["single_core_bound"] else "no"
        click.echo(
            f"gateway {gw}: {budget['cores_effective']:.2f} cores used, "
            f"GIL wait {100.0 * budget['gil_wait_fraction']:.1f}% "
            f"(cross-check {100.0 * budget['gil_wait_expected']:.1f}%), "
            f"{budget['samples']} samples — single-core-bound: {verdict}"
        )
        for row in budget["top_stages"]:
            click.echo(f"  {row['stage']:<12} {row['cpu_s']:>9.3f}s cpu")
        for line in (payload.get("folded") or [])[: max(0, top)]:
            click.echo(f"  {line}")
        ss = payload.get("speedscope")
        if ss and output:
            # merge gateways into one speedscope file: per-gateway frame
            # tables re-index into one shared table, profile names prefix
            # the gateway id so threads stay attributable
            base_idx = len(merged_frames)
            merged_frames.extend(ss.get("shared", {}).get("frames", []))
            for prof in ss.get("profiles", []):
                shifted = dict(prof)
                shifted["name"] = f"{gw}:{prof.get('name', '?')}"
                shifted["samples"] = [[i + base_idx for i in s] for s in prof.get("samples", [])]
                merged_profiles.append(shifted)
    if output:
        if not merged_profiles:
            raise click.ClickException("nothing to write: no gateway returned profiler stacks")
        doc = {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "name": "skyplane-tpu flame",
            "exporter": "skyplane-tpu-profiler",
            "shared": {"frames": merged_frames},
            "profiles": merged_profiles,
        }
        with open(output, "w") as f:
            json_mod.dump(doc, f)
        click.echo(f"wrote {output} ({len(merged_profiles)} thread track(s)); open it at https://www.speedscope.app")


@main.command()
@click.argument("transfer_id", default="latest")
@click.option("--fleet-dir", default=None, help="fleet event-log directory (default: SKYPLANE_TPU_FLEET_DIR or /tmp/skyplane_tpu_fleet)")
@click.option("--trace", "trace_path", default=None, help="optional (merged) Chrome trace JSON adding per-hop stage rows")
@click.option("--url", default=None, help="service API base URL: fetch GET /api/v1/timeline from a live controller instead of a fleet log")
@click.option("--token", default=None, help="bearer token for --url (defaults to none)")
@click.option("--src-region", default=None, help="source region tag for the $/TB footer (default: inferred from events, else local)")
@click.option("--dst-region", default=None, help="destination region tag for the $/TB footer")
@click.option("--json", "as_json", is_flag=True, help="print the full report (timeline + critical path + fit) as JSON")
@click.option("--perfetto", "perfetto_out", default=None, help="also write the timeline as a Perfetto/Chrome trace here")
def timeline(transfer_id, fleet_dir, trace_path, url, token, src_region, dst_region, as_json, perfetto_out):
    """Job waterfall + critical path: where did this transfer's wall-clock
    go (docs/observability.md "Job timelines & critical path").

    Reads the fleet event log a collected transfer banked
    (SKYPLANE_TPU_COLLECT=1; TRANSFER_ID matches the job id or the log
    filename, default `latest`), pairs the phase.plan/provision/.../drain
    events into intervals, solves the longest weighted path through them,
    and prints the waterfall with a fixed-vs-byte-scaled split. With --url
    it asks a live service controller (GET /api/v1/timeline) instead."""
    import json as json_mod

    from skyplane_tpu_torch.obs.timeline import (
        load_fleet_log,
        perfetto_export,
        resolve_fleet_log,
        timeline_report,
    )

    if url:
        from skyplane_tpu_torch.gateway.control_auth import control_session
        from skyplane_tpu_torch.obs.collector import api_base_of

        params = {} if transfer_id == "latest" else {"job": transfer_id}
        resp = control_session(token).get(f"{api_base_of(url)}/timeline", params=params, timeout=30)
        resp.raise_for_status()
        report = resp.json()
        click.echo(json_mod.dumps(report, indent=2) if as_json else report.get("text", ""))
        return

    log_path = resolve_fleet_log(transfer_id, fleet_dir)
    if log_path is None:
        raise click.ClickException(
            f"no fleet event log matches {transfer_id!r} — run the transfer with SKYPLANE_TPU_COLLECT=1 "
            "(and optionally SKYPLANE_TPU_FLEET_DIR; docs/observability.md)"
        )
    events = load_fleet_log(log_path)
    traces = None
    if trace_path:
        with open(trace_path) as f:
            traces = json_mod.load(f)
    job = None if transfer_id == "latest" else transfer_id
    if job is not None:
        # expand a git-style id prefix to the full job tag the events carry —
        # the builder's job filter matches exactly
        job = next(
            (str(e["job"]) for e in events if isinstance(e.get("job"), str) and e["job"].startswith(job)),
            job,
        )
    # $/TB footer: explicit region pair, else the regions the fleet events
    # carry (loopback fleets tag local:local, which prices to $0)
    regions = [str(e["region"]) for e in events if e.get("region")]
    src = src_region or (regions[0] if regions else "local:local")
    dst = dst_region or next((r for r in regions if r != src), src)
    from skyplane_tpu_torch.planner.pricing import get_egress_cost_per_gb

    report = timeline_report(events, traces=traces, job=job, cost_per_gb=get_egress_cost_per_gb(src, dst))
    if perfetto_out:
        with open(perfetto_out, "w") as f:
            json_mod.dump(perfetto_export(report["timeline"], report["critical_path"]), f)
    if as_json:
        report = dict(report)
        report["fleet_log"] = str(log_path)
        click.echo(json_mod.dumps(report, indent=2))
    else:
        click.echo(f"fleet log: {log_path}")
        click.echo(report["text"])
        if perfetto_out:
            click.echo(f"wrote {perfetto_out}; open it in https://ui.perfetto.dev")
    if not report["timeline"]["phases"]:
        raise click.ClickException(
            "the log holds no phase events — the transfer predates the timeline instrumentation?"
        )


@main.command()
@click.option("--url", "urls", multiple=True, required=True, help="gateway control URL(s); repeatable")
@click.option("--token", default=None, help="gateway API bearer token (defaults to none)")
@click.option("--interval", default=2.0, type=float, help="refresh interval seconds")
@click.option("--once", is_flag=True, help="one snapshot, no screen refresh loop (scripting / smoke tests)")
@click.option("--count", default=0, type=int, help="stop after N refreshes (0 = until interrupted)")
def monitor(urls, token, interval, once, count):
    """Live fleet dashboard: per-gateway Gbps, in-flight bytes, dedup hit
    rate, staleness, and the flight-recorder event tail — the scrape-merge
    loop of the TelemetryCollector rendered for a terminal
    (docs/observability.md)."""
    import time as time_mod

    from skyplane_tpu_torch.gateway.control_auth import control_session
    from skyplane_tpu_torch.obs.collector import (
        GatewayTarget,
        TelemetryCollector,
        api_base_of,
        cpu_gil_cells,
        parse_prometheus,
    )

    targets = []
    for u in urls:
        base = api_base_of(u)
        gid, region = base, ""
        try:
            status = control_session(token).get(f"{base}/status", timeout=5).json()
            gid, region = status.get("gateway_id") or base, status.get("region") or ""
        except Exception:  # noqa: BLE001 — identity probe best-effort; collector marks it stale
            pass
        targets.append(GatewayTarget(gid, base, region=region, session_fn=lambda: control_session(token)))
    # cpu_every=1: the dashboard's CPU%/GIL% columns are scrape deltas — a
    # thinned CPU cadence would smear them across poll intervals
    collector = TelemetryCollector(targets, poll_interval_s=interval, label="monitor", cpu_every=1)

    def sample(name_sub: str, metrics: dict) -> float:
        return sum(v for k, v in metrics.items() if k.endswith(name_sub))

    prev: dict = {}
    prev_t: dict = {}
    prev_cpu: dict = {}
    rounds = 0
    while True:
        collector.poll_once()
        now = time_mod.monotonic()
        lines = [f"skyplane-tpu monitor — {len(targets)} gateway(s), interval {interval:g}s"]
        with collector._lock:
            states = list(collector._states.values())
        for st in states:
            gid = st.target.gateway_id
            if st.stale or st.metrics_text is None:
                lines.append(f"  {gid:<24} STALE ({st.consec_failures} failed scrapes)")
                continue
            samples = parse_prometheus(st.metrics_text)
            metrics = {name: value for name, _, value in samples}
            sent = sample("sender_wire_wire_bytes_sent", metrics) + sample("decode_decode_raw_bytes", metrics)
            dt = now - prev_t.get(gid, now)
            gbps = (sent - prev.get(gid, sent)) * 8 / 1e9 / dt if dt > 0 else 0.0
            prev[gid], prev_t[gid] = sent, now
            inflight = sample("sender_wire_wire_inflight_bytes", metrics)
            segs = sample("datapath_segments", metrics)
            refs = sample("datapath_ref_segments", metrics)
            hit = f"{100.0 * refs / segs:.1f}%" if segs else "-"
            tenants_n = len({lbl for name, lbl, _ in samples if name == "skyplane_tenant_bytes_delivered"})
            # core-time columns (docs/observability.md "Core-time profiling"):
            # CPU% from /telemetry cpu deltas, GIL% from the profiler summary
            # — old gateways (404) and unarmed profilers render "—"
            cpu_cell, gil_cell, cpu_now = cpu_gil_cells(st.cpu, prev_cpu.get(gid), dt, st.profile)
            if cpu_now is not None:
                prev_cpu[gid] = cpu_now
            lines.append(
                f"  {gid:<24} {gbps:7.3f} Gbps   in-flight {inflight / 1e6:8.1f} MB   "
                f"dedup hit {hit:>6}   cpu {cpu_cell:>5}   gil {gil_cell:>4}   "
                f"nacks {int(sample('decode_decode_nacks', metrics))}"
                + (f"   tenants {tenants_n}" if tenants_n else "")
            )
        events = collector.fleet_events()[-8:]
        if events:
            lines.append("  recent events:")
            for ev in events:
                detail = {k: v for k, v in ev.items() if k not in ("seq", "ts", "kind", "recorder", "gateway")}
                lines.append(f"    [{ev.get('gateway', '?')}] {ev['kind']} {detail if detail else ''}")
        if not once and rounds > 0:
            click.clear()
        click.echo("\n".join(lines))
        rounds += 1
        if once or (count and rounds >= count):
            break
        time_mod.sleep(interval)


@main.command()
@click.option("--url", required=True, help="gateway control URL, e.g. https://10.0.0.5:8081")
@click.option("--token", default=None, help="gateway API bearer token (defaults to none)")
def tenants(url, token):
    """Show a gateway's tenant/job registry: admissions, per-tenant chunk and
    byte accounting, fair-share scheduler usage (docs/multitenancy.md)."""
    from skyplane_tpu_torch.gateway.control_auth import control_session

    resp = control_session(token).get(f"{url.rstrip('/')}/api/v1/tenants", timeout=30)
    resp.raise_for_status()
    snap = resp.json()
    tenant_map = snap.get("tenants", {})
    if not tenant_map:
        click.echo("no tenants registered on this gateway")
        return
    click.echo(f"{len(snap.get('jobs', {}))} active jobs, {len(tenant_map)} tenants "
               f"(caps: {snap.get('max_jobs_per_tenant')}/tenant, {snap.get('max_jobs_total')} total)")
    for tenant_id in sorted(tenant_map):
        s = tenant_map[tenant_id]
        click.echo(
            f"  {tenant_id}: jobs {s['active_jobs']} active / {s['jobs_admitted']} admitted "
            f"/ {s['jobs_rejected']} rejected · {s['chunks_registered']} chunks "
            f"({s['bytes_registered'] / 1e6:.1f} MB) registered · "
            f"{s['bytes_delivered'] / 1e6:.1f} MB delivered · "
            f"{s['decode_raw_bytes'] / 1e6:.1f} MB decoded · {s['nacks']} nacks"
        )


@main.command()
@click.option("--index", default=0, help="gateway index to connect to")
def ssh(index):
    """SSH into a running gateway VM."""
    from skyplane_tpu_torch.cli.cli_cloud import run_ssh

    sys.exit(run_ssh(index))


@main.group()
def experiments():
    """Profiling experiments (throughput grids for the solver)."""


@experiments.command("throughput-grid")
@click.argument("region_pairs", nargs=-1, required=True)
@click.option("--output", default="throughput_grid.csv", help="profile CSV consumed by the solver")
@click.option("--probe-mb", default=256, type=int)
@click.option("--no-resume", is_flag=True)
def experiments_throughput_grid(region_pairs, output, probe_mb, no_resume):
    """Measure pairwise gateway throughput: PAIRS like aws:us-east-1,gcp:us-central1"""
    from skyplane_tpu_torch.cli.experiments.throughput_grid import run_throughput_grid

    pairs = []
    for spec in region_pairs:
        src, _, dst = spec.partition(",")
        if not dst:
            raise click.ClickException(f"pair must be 'src_region,dst_region', got {spec!r}")
        if src == dst:
            raise click.ClickException(f"self-pair {spec!r}: src and dst regions must differ")
        pairs.append((src, dst))
    results = run_throughput_grid(pairs, output, probe_mb=probe_mb, resume=not no_resume)
    for (src, dst), gbps in sorted(results.items()):
        click.echo(f"{src} -> {dst}: {gbps:.2f} Gbps")


@experiments.command("latency-grid")
@click.argument("region_pairs", nargs=-1, required=True)
@click.option("--output", default="latency_grid.csv", help="RTT matrix CSV")
@click.option("--no-resume", is_flag=True)
def experiments_latency_grid(region_pairs, output, no_resume):
    """Measure pairwise gateway RTT: PAIRS like aws:us-east-1,gcp:us-central1"""
    from skyplane_tpu_torch.cli.experiments.latency_grid import run_latency_grid

    pairs = []
    for spec in region_pairs:
        src, _, dst = spec.partition(",")
        if not dst:
            raise click.ClickException(f"pair must be 'src_region,dst_region', got {spec!r}")
        pairs.append((src, dst))
    results = run_latency_grid(pairs, output, resume=not no_resume)
    for (src, dst), rtt in sorted(results.items()):
        click.echo(f"{src} -> {dst}: {rtt:.1f} ms")


@experiments.command("query")
@click.argument("src")
@click.argument("dst")
@click.option("--profile", default=None, help="grid CSV (default: the init-captured throughput grid)")
def experiments_query(src, dst, profile):
    """Query the measured/estimated path throughput and egress cost for a
    region pair (reference analog: cli/experiments/cli_query.py)."""
    from pathlib import Path

    from skyplane_tpu_torch.config_paths import throughput_grid_path
    from skyplane_tpu_torch.planner.pricing import get_egress_cost_per_gb
    from skyplane_tpu_torch.planner.solver import ThroughputSolver

    if profile and not Path(profile).exists():
        # an explicit but missing profile must not silently degrade to the
        # NIC-limit estimate — the operator thinks they queried measurements
        raise click.ClickException(f"profile not found: {profile}")
    solver = ThroughputSolver(profile or str(throughput_grid_path))
    gbps = solver.get_path_throughput(src, dst)  # already Gbps
    # label must mirror get_path_throughput's branch order: the src==dst
    # branch wins over a grid hit, so such a value is NOT a measurement
    kind = "measured" if (src, dst) in solver.grid and src != dst else "estimated (NIC-limit model)"
    click.echo(f"{src} -> {dst}: {gbps:.2f} Gbps [{kind}], ${get_egress_cost_per_gb(src, dst):.3f}/GB egress")


@main.group()
def config():
    """Get or set configuration flags."""


@config.command("get")
@click.argument("name")
def config_get(name):
    from skyplane_tpu_torch.config_paths import cloud_config
    from skyplane_tpu_torch.exceptions import BadConfigException

    try:
        click.echo(cloud_config.get_flag(name))
    except BadConfigException as e:
        raise click.ClickException(str(e)) from e


@config.command("set")
@click.argument("name")
@click.argument("value")
def config_set(name, value):
    from skyplane_tpu_torch.config_paths import cloud_config, config_path
    from skyplane_tpu_torch.exceptions import BadConfigException

    cfg = cloud_config.reload()
    try:
        cfg.set_flag(name, value)
    except BadConfigException as e:
        raise click.ClickException(str(e)) from e
    cfg.to_config_file(config_path)
    click.echo(f"Set {name} = {cfg.get_flag(name)}")


@config.command("list")
def config_list():
    from skyplane_tpu_torch.config import SkyplaneConfig
    from skyplane_tpu_torch.config_paths import cloud_config

    cfg = cloud_config
    for name in SkyplaneConfig.flag_names():
        click.echo(f"{name} = {cfg.get_flag(name)}")


if __name__ == "__main__":
    main()
