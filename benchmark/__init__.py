"""The benchmark of ``phfpfac_tpu_torch`` on one H100, to the contract of
``BENCHMARK.json`` at the repository's root.

* ``run.py`` — one run of one cell (the command ``BENCHMARK.json`` names);
* ``spec.py`` — cells, configurations, traffic mixes, loops, dictionary
  and corpus kinds, references and metrics found by name:
  ``configs/<name>.json``, ``traffic/<name>.json``, ``loops/<kind>.py``,
  ``gen/dictionaries/<kind>.py``, ``gen/corpora/<kind>.py``,
  ``reference/<name>.py``, ``metrics/<name>.py`` (one reader a metric);
* ``gen/`` — the seeded generators of dictionaries and corpora;
* ``loops/`` — the closed loops a traffic mix names, one file a kind;
* ``clock.py``, ``trace.py``, ``spans.py`` — stage timers swapped into
  the program, ``torch.profiler`` over the window, and the program's
  spans and counters as the result path's readers take them;
* ``reference/``, ``check.py``, ``work.py`` — the plain references (``ac``
  unless a configuration names another), the comparison that decides
  ``correct``, the scan's least bytes;
* ``sets.py``, ``control.py`` — runs in sets and their spread (what a
  bound is set from), and the controls of ``correct``;
* ``tests/`` — CPU tests: ``python -m pytest benchmark/tests``.

Nothing here imports ``jax`` or ``phfpfac_tpu``; ``reference/`` imports
nothing of the program.
"""
