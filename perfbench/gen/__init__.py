"""Input generators, one module per configuration family, found by the
``generator`` key of a configuration file."""
