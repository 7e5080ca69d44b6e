"""A fleet for the benchmark's own tests, named by a configuration's
``fleet`` key: the source sends to an interior sink, which lands each chunk
and forwards it to a leaf sink, by the program the blast planner writes for
an interior sink (``receive`` -> ``mux_and`` -> [``write_local``, ``send``],
``docs/blast.md``). Both sinks' landed files are checked. ``counters()``
adds a ``relay`` group: the interior sink's sender wire counters."""

from pbench.fleet import Fleet as StarFleet
from pbench.fleet import SinkProcess, gateway_info, send_op


class Fleet(StarFleet):
    def spawn(self, key_file) -> None:
        cfg = self.cfg
        leaf = SinkProcess(self.work, 1, cfg, key_file)
        self.sinks.append(leaf)
        forward = dict(send_op(cfg, "send_leaf", leaf, cfg["sink_regions"][1]), peer_serve=True)
        self.sinks.insert(0, SinkProcess(self.work, 0, cfg, key_file, sends=[forward], info=gateway_info([leaf])))

    def source_children(self) -> list:
        return [send_op(self.cfg, "send0", self.sinks[0], self.cfg["sink_regions"][0])]

    def counters(self) -> dict:
        groups = super().counters()
        groups["relay"] = self.sinks[0].get("profile/socket/sender")["counters"]
        return groups
