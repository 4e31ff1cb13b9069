from .mesh import (
    Group,
    all_gather_cat,
    all_reduce_sum,
    barrier,
    broadcast,
    group_device,
    initialize_runtime,
    placement,
    shutdown_runtime,
)

__all__ = [
    "Group",
    "all_gather_cat",
    "all_reduce_sum",
    "barrier",
    "broadcast",
    "group_device",
    "initialize_runtime",
    "placement",
    "shutdown_runtime",
]
