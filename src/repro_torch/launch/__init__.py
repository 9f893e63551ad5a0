"""Launchers of the port: ``train`` (the training driver with checkpoint
and restart), ``serve`` (the RAC-fronted serving engine over a trace),
``mesh`` (the cache mesh, the production, local and abstract meshes),
``dryrun`` (every arch x shape cell on a fake 256/512-rank world, meta
DTensors laid out by the sharding plan) with its cost model ``op_cost``,
``roofline`` (H100 datasheet terms) and ``profile_cell`` (a cell's top
ops)."""
