from .topology import (
    MeshTopology, MESH_AXES, set_topology, get_topology, topology_initialized,
    reset_topology, get_data_parallel_world_size, get_model_parallel_world_size,
    get_expert_parallel_world_size, get_sequence_parallel_world_size,
    get_pipeline_parallel_world_size,
)
