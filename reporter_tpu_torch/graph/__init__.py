from .network import RoadNetwork, network_from_arrays
from .route import (UNREACHABLE, RouteCache, candidate_route_matrices,
                    shortest_path_edges)
from .spatial import PAD_DIST, PAD_EDGE, CandidateSet, SpatialGrid

__all__ = ["RoadNetwork", "network_from_arrays", "UNREACHABLE", "RouteCache",
           "candidate_route_matrices", "shortest_path_edges", "PAD_DIST",
           "PAD_EDGE", "CandidateSet", "SpatialGrid"]
