"""Launchers of the port: ``serve`` (the RAC-fronted serving engine over a
trace).  Training and the dry-run tooling wait for ``ROADMAP.md`` queue A
item 12."""
