"""Metric readers, one file per metric, named as in ``BENCHMARK.json``.

``<name>.py`` holds ``read(run) -> float | None``: the metric of one run
(``harness.Run``: its jobs, their logs and exports, the window, the
set-up and, in a traced run, the ``trace.Trace``), or None when the run
holds nothing to read it from, in which case the result leaves it out.
``nfa_sliced_work.py`` counts the work the count kernel's inputs need.
"""
