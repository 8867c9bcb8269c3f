"""Traffic drivers, picked by the ``driver`` of a traffic file:
``run(ctx) -> readings``. Each makes its inputs from the seed, builds and
warms the system under test, measures inside ``ctx.window()`` (ending
its trace with ``end_trace()`` once its own threads are quiet, where it
has any), and returns
the raw readings the metric readers take, with ``check``: the sample that
``check.py`` compares."""
