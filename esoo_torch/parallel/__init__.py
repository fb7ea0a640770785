from .sharded import (
    OrbitalMesh,
    ShardedOrbitalOptimizer,
    make_orbital_mesh,
    make_orbital_state_mesh,
    rotate_two_body_sharded,
    shard_problem_tensors,
    shard_sector_tables,
    sharded_bb_step,
    sharded_rotated_energy,
    sharded_spatial_energy,
)

__all__ = [
    "OrbitalMesh",
    "ShardedOrbitalOptimizer",
    "make_orbital_mesh",
    "make_orbital_state_mesh",
    "rotate_two_body_sharded",
    "shard_problem_tensors",
    "shard_sector_tables",
    "sharded_bb_step",
    "sharded_rotated_energy",
    "sharded_spatial_energy",
]
