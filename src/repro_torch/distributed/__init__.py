from repro_torch.distributed.collectives import (
    SignMessage,
    decode_sign_message,
    encode_sign_message,
    message_bytes,
    sign_sum,
)
from repro_torch.distributed.context import (
    check_model_axis,
    clear_mesh,
    get_mesh,
    set_mesh,
)
from repro_torch.distributed.sharding import (
    MeshShape,
    P,
    PartitionSpec,
    ShardingPlan,
    greedy_spec,
    local_tree,
    make_plan,
    map_specs,
    named,
    place_tree,
)

__all__ = [
    "MeshShape",
    "P",
    "PartitionSpec",
    "ShardingPlan",
    "SignMessage",
    "check_model_axis",
    "clear_mesh",
    "decode_sign_message",
    "encode_sign_message",
    "get_mesh",
    "greedy_spec",
    "local_tree",
    "make_plan",
    "map_specs",
    "message_bytes",
    "named",
    "place_tree",
    "set_mesh",
    "sign_sum",
]
