"""Multi-device plumbing of the port: the graph axes of the reference's
logical-axis rules and the ambient ``torch.distributed`` device mesh that
sharded grouped NA binds to (``sharding``); int8 gradient compression with
error feedback (``compression``)."""
