"""The benchmark's harness: it finds a cell's configuration, family, traffic
mix, entry, reference and per-layer metrics by the names in BENCHMARK.json,
drives the program under test, and judges its answers.  Of the benchmark's
files only ``harness/port.py``, ``families/`` and ``entries/`` import the
package under test."""
