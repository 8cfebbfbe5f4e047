"""Cost models of a step: closed-form FLOPs and device-memory bytes, the
roofline terms on the H100, and the collectives of a sharded call."""
