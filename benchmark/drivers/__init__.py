"""Drivers: one module a kind of traffic. ``run(ctx)`` builds the cell's
inputs, starts the program, opens and closes the window through ``ctx``,
checks what the program produced, and returns its end-to-end numbers,
checks and work counts (``benchmark.run`` documents the keys)."""
