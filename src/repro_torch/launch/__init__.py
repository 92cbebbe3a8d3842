"""Process entry points of the port: ``shard_server``, one standalone shard
server of the TCP server tier."""
