"""One module a scheme: how a cell of that scheme sets up, serves a request
and is checked. ``harness`` finds it by the configuration's ``scheme``."""
