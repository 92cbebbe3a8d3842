"""Process entry points and planning of the port: ``shard_server`` (one
standalone shard server of the TCP server tier), ``train`` and ``serve``
(the reference's launchers), ``mesh`` (device meshes and process groups),
``roofline`` and ``dryrun`` (a sharded step planned on a fake world)."""
