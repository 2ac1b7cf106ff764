"""Traffic drivers, one module per kind of loop, found by the ``driver``
key of a traffic file."""
