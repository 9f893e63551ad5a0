"""Launchers of the port: ``serve`` (the RAC-fronted serving engine over a
trace) and ``mesh`` (the cards of the sharded cache).  Training and the
dry-run tooling wait for ``ROADMAP.md`` queue A item 12."""
