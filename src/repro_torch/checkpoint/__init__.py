"""Checkpointing and the wire codec: msgpack-serialized parameter trees."""
