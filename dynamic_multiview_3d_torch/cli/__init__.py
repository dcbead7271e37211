"""CLI entry points (port of cli/): train, snapshot, eval, predict."""
