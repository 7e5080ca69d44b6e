"""Planner pieces the gateway needs: the region-pair egress price grid
(``pricing.py``). The planner itself (solver, topology, replan) waits for the
control-plane slice (ROADMAP queue 1 item 7)."""
