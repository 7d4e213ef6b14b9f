"""``repro_torch.graph`` — decentralized LAG over gossip topologies, lazy
edges (port of ``repro.graph``).

``graph:W@<family>`` builds a gossip graph (ring / torus / complete /
expander / small-world, Metropolis doubly-stochastic mixing:
``spec``) whose round is the adapt-then-combine diffusion θ_i ← Σ_j W_ij
ψ̂_j, where each of the E DIRECTED EDGES owns its own 15a-style trigger
state through the unchanged ``CommPolicy`` seam: dense, ``laq@b`` and
scheduled policies all compose per edge, the per-edge mirrors are
``(E, rows, 128)`` plane buffers, and a quiet edge moves zero bytes — its
destination mixes with the last-received copy.

Spec: ``Experiment(topology="graph:9@ring")`` (convex or deep), the
launcher's ``--topology graph:4@ring``; ``netsim.price_edge_mask`` prices
the (K, E) edge mask with one link draw per directed edge.
"""
from repro_torch.graph.rounds import (EDGE_PREFIX, EdgeMap, adapt,
                                      edge_round, graph_round,
                                      init_edge_state, init_graph_state,
                                      make_graph_step, mix, node_params,
                                      run_convex)
from repro_torch.graph.spec import (GRAPH_GRAMMAR, GraphSpec, build_graph,
                                    connected, metropolis_mixing)
from repro_torch.graph.topology import GraphTopology

__all__ = [
    "GraphTopology", "GraphSpec", "GRAPH_GRAMMAR", "build_graph",
    "connected", "metropolis_mixing", "EDGE_PREFIX", "EdgeMap", "adapt",
    "edge_round", "graph_round", "init_edge_state", "init_graph_state",
    "make_graph_step", "mix", "node_params", "run_convex",
]
