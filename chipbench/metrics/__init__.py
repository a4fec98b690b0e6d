"""One reader a metric, found by the metric's name: ``read(ctx)`` returns
the metric's value, or None where the run has nothing to read it from (the
harness then leaves the metric out of the result line).  ``ctx`` is
:class:`chipbench.run.Context`."""
