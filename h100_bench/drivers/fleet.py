"""Closed loop, one client: fleets solved back to back, cold (the
configuration's class ``make`` gives fleet ``index`` of a run).  Set-up
solves fleet 0; the window's units are fleets 1, 2, ..."""

from __future__ import annotations

FIRST_UNIT = 1


def setup(run):
    run.solve(run.cls.make(run.cfg, run.traffic, run.seed, 0, run.device))
    return None


def unit(run, state, index):
    """Solve fleet ``index``; the unit's key for the check is the index."""
    problems = run.cls.make(run.cfg, run.traffic, run.seed, index, run.device)
    return run.solve(problems), index
