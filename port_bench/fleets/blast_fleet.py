"""The checkpoint blast of ``docs/blast.md`` as the port runs it, named by a
configuration's ``fleet`` key.

One source pushes each chunk to a tree of sinks that peer: the port's
``solve_blast_tree`` places the tree over the configuration's sinks (every
edge costs the same on a loopback, so depth decides it) at this fleet's
``FANOUT`` 3 and ``SOURCE_DEGREE`` 1, the blast planner's defaults, which the
configuration states under ``assumed``; and ``build_local_blast_programs`` writes every
gateway's program, with the connections the planner gives each edge. Every
interior sink runs ``receive`` -> ``mux_and`` -> [``write_local``,
``send`` (peer-serve) a child...]: it decodes each chunk, lands it, and
encodes it again for each child against its own dedup index, on a batch
runner of its own. Before any daemon starts, the fleet refuses a tree whose
cost or total depth differs from the plain reference's
(``port_bench/reference/blast_tree_ref.py``).

Interior sinks run on the device ``SKYPLANE_GATEWAY_DEVICE`` names in the
harness's environment, ``cuda`` when unset (the benchmark: a process of its
own on the source's card); on the CPU (the benchmark's own tests) they
build a runner all the same (``SKYPLANE_TPU_SPMD=on``). The fleet spawns
them before the harness names its device, so ``start_source(device)``
refuses a device of another type than theirs. Leaves run on the CPU. Every
gateway's daemon cuts segments by the daemon's CDC sizes, which the
configurations state; the control changes the source's alone.

``counters()`` adds the ``relay`` group, summed over the interior sinks and
read from their control APIs: the sender data path and the runner
(``/api/v1/profile/compression``) and the wire
(``/api/v1/profile/socket/sender``). Before they stop, each interior sink's
kernel launches (``/api/v1/profile/kernels``) go to standard error; on the
card, ``stop()`` then fails the run if an interior sink launched no
``gear_compact`` (K-AB) or no ``segment_fp`` (K-C).
"""

import json
import os
import sys

from pbench.fleet import Fleet as StarFleet
from pbench.fleet import SinkProcess, _sum_numeric, gateway_info
from reference import blast_tree_ref

SOURCE_ID = "gw_src"
#: the tree's degree bounds: a relay's children, and the source's
FANOUT, SOURCE_DEGREE = 3, 1
#: the kernels every encode on the card launches: K-AB and K-C
RELAY_KERNELS = ("gear_compact", "segment_fp")


def zero_cost(a: str, b: str) -> float:
    return 0.0


def solve(cfg: dict, fanout: int = FANOUT, source_degree: int = SOURCE_DEGREE):
    """The port's tree over the configuration's sinks, ``gw_sink<i>`` in
    ``sink_regions`` order, held to the reference's best (cost, total
    depth): raises ValueError where they differ or the tree breaks a bound."""
    from skyplane_tpu_torch.blast import solve_blast_tree

    regions = {f"gw_sink{i}": r for i, r in enumerate(cfg["sink_regions"][: cfg["sinks"]])}
    tree = solve_blast_tree(SOURCE_ID, regions, cfg["source_region"], cost_fn=zero_cost, fanout=fanout,
                            source_degree=source_degree)
    want = blast_tree_ref.best_tree(SOURCE_ID, regions, cfg["source_region"], zero_cost, fanout, source_degree)
    got = blast_tree_ref.score(SOURCE_ID, tree.parent, tree.regions, zero_cost)
    if got != (want.cost, want.depth) or not blast_tree_ref.within_bounds(SOURCE_ID, tree.parent, fanout,
                                                                          source_degree):
        raise ValueError(f"fanout/source_degree: the port's tree {tree.edges()} scores (cost, total depth) {got}; "
                         f"the reference's best {want.parent} scores {(want.cost, want.depth)}")
    return tree


class Fleet(StarFleet):
    def spawn(self, key_file) -> None:
        from skyplane_tpu_torch.blast import build_local_blast_programs, start_order

        cfg = self.cfg
        self.relays, self.checked = [], False
        tree = solve(cfg)
        roots = {node: str(self.work / f"sink{int(node[len('gw_sink'):])}") for node in tree.sinks()}
        self.programs = build_local_blast_programs(tree, roots, num_connections=cfg["num_connections"],
                                                   compress=cfg["codec"], dedup=cfg["dedup"],
                                                   encrypt=cfg["encrypt_e2e"])
        device = self.relay_device = os.environ.get("SKYPLANE_GATEWAY_DEVICE", "cuda")
        relay_env = {"SKYPLANE_GATEWAY_DEVICE": device, **({"SKYPLANE_TPU_SPMD": "on"} if device == "cpu" else {})}
        by_id = {}
        for node in start_order(tree)[:-1]:  # leaves first, the source last
            index, children = int(node[len("gw_sink"):]), tree.children(node)
            if children:
                mux = self.programs[node]["plan"][0]["value"][0]["children"][0]
                sink = SinkProcess(self.work, index, cfg, key_file, sends=mux["children"][1:],
                                   info=gateway_info([by_id[c] for c in children]), env=relay_env)
            else:
                sink = SinkProcess(self.work, index, cfg, key_file)
            by_id[node] = sink
            self.sinks.append(sink)
            program = json.loads((self.work / f"sink{index}.program.json").read_text())
            if program != self.programs[node]:
                raise RuntimeError(f"sink {node} runs {program}, not the blast program {self.programs[node]}")
        self.sinks.sort(key=lambda s: s.index)
        self.relays = [by_id[node] for node in tree.interior_nodes()]

    def start_source(self, device) -> None:
        if self.relays and device.type != self.relay_device.split(":")[0]:
            raise ValueError(f"the harness runs on {device} but the relay on SKYPLANE_GATEWAY_DEVICE="
                             f"{self.relay_device}: set it to {device.type} or unset it")
        super().start_source(device)

    def source_children(self) -> list:
        return self.programs[SOURCE_ID]["plan"][0]["value"][0]["children"]

    def counters(self) -> dict:
        groups = super().counters()
        groups["relay"] = _sum_numeric({**g.get("profile/compression"), **g.get("profile/socket/sender")["counters"]}
                                       for g in self.relays)
        return groups

    def stop(self) -> None:
        """Stop every daemon; on the card, once the source ran, raise if an
        interior sink launched no K-AB or no K-C (its encodes left the card)."""
        idle = []
        for g in self.relays:
            if g.proc.poll() is not None:
                idle.append(g.gateway_id)
                continue
            try:
                launches = g.get("profile/kernels", timeout=10)
            except Exception as err:  # noqa: BLE001 - a relay that cannot answer is stopped below
                launches = repr(err)
            print(f"[port_bench] relay {g.gateway_id} kernel launches since it started: {launches}", file=sys.stderr,
                  flush=True)
            if not isinstance(launches, dict) or not all(launches.get(k, 0) > 0 for k in RELAY_KERNELS):
                idle.append(g.gateway_id)
        check, self.checked = self.source is not None and not self.checked, True
        super().stop()
        if check and self.relay_device != "cpu" and idle:
            raise RuntimeError(f"relay(s) {idle} on {self.relay_device} launched no {' or '.join(RELAY_KERNELS)}")
