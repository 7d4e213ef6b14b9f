"""``GraphTopology`` — a decentralized gossip plane with no server — port
of ``repro.graph.topology``.

``graph:W@<family>`` (parsed by ``repro_torch.engine.make_topology``): W
nodes each holding its OWN iterate θ_i, connected by the family's
undirected graph.  One round is the adapt-then-combine diffusion step

    ψ_i  = θ_i − α·W·∇L_i(θ_i)                        (local adapt)
    θ_i' = W_ii·ψ_i + Σ_{j∈N(i)} W_ij·ψ̂_{j→i}        (lazy mixing)

where W is the Metropolis mixing matrix (``repro_torch.graph.spec``) and
ψ̂_{j→i} is the copy of neighbor j's iterate that edge (j→i) LAST
TRANSMITTED: each of the E directed edges owns its own 15a-style trigger
state through the unchanged ``CommPolicy`` seam, so a quiet edge moves
zero bytes and its destination mixes with the stale mirror.  The lazy
units of the edge round are the E directed EDGES, while batches split
over the W nodes — hence ``units()`` returns W.

Entry points: ``repro_torch.graph.rounds.run_convex`` (convex, a host
loop of K rounds) and ``init_graph_state`` / ``make_graph_step`` (deep,
the trainer's shape).  ``Experiment(topology="graph:9@ring")`` front-doors
both; ``netsim.price_edge_mask`` prices the per-edge upload mask with one
link draw per directed edge.
"""
from __future__ import annotations

from repro_torch.engine.topology import Topology
from repro_torch.graph.spec import GraphSpec, build_graph


class GraphTopology(Topology):
    name = "graph"
    kind = "deep"            # deep step native; convex via graph.run_convex

    def __init__(self, num_nodes: int, family: str, seed: int = 0):
        # realize the spec eagerly: a malformed family fails at
        # make_topology time, before any round runs
        spec = build_graph(num_nodes, family, seed=seed)
        super().__init__(num_units=spec.num_nodes)
        self.spec: GraphSpec = spec
        self.family = spec.family
        self.seed = spec.seed

    @property
    def num_nodes(self) -> int:
        return self.spec.num_nodes

    @property
    def num_edges(self) -> int:
        """Directed edge count E: the width of ``comm_mask`` and the unit
        count of the per-edge policy round."""
        return self.spec.num_edges

    def units(self, default: int) -> int:
        """Batch placement is per NODE (each node trains on its own
        shard); the per-edge laziness lives inside the round."""
        return self.num_nodes

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"GraphTopology(family={self.family!r}, "
                f"W={self.num_nodes}, E={self.num_edges}, "
                f"seed={self.seed})")
