"""Traffic kinds: one module a kind, named by the ``kind`` of a traffic
file. Each exposes ``setup(run)``, ``window(state, seconds)``,
``release(state)``, ``check(state, win)`` and ``work(run)`` (what one unit
of the cell's work is, for the per-layer metrics)."""
