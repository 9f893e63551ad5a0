"""Launchers of the port: ``train`` (the training driver with checkpoint
and restart), ``serve`` (the RAC-fronted serving engine over a trace) and
``mesh`` (the cards of the sharded cache).  The dry-run tooling of the
reference's XLA mesh waits for ``ROADMAP.md`` queue A item 12."""
