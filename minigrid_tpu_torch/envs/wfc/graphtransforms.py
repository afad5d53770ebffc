"""Grid <-> dense-graph conversions for offline analysis (DRED-style).

Counterpart of ``minigrid_tpu/envs/wfc/graphtransforms.py``, the host-side
analogue of the reference's GraphTransforms (reference:
minigrid/envs/wfc/graphtransforms.py:14-389): encoded layouts become
networkx grid graphs with one-hot node features, and binary feature graphs
convert back to encoded minigrid arrays.  An offline analysis tool, in
numpy and networkx (imported only when a graph is built); inputs may be
numpy arrays, torch tensors or the port's batched ``EnvState``.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import product

import numpy as np

from minigrid_tpu_torch.core.constants import COLOR_TO_IDX, IDX_TO_OBJECT, OBJECT_TO_IDX


def _numpy(x) -> np.ndarray:
    """A numpy array of ``x`` (a torch tensor on any device, or array-like)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _require_networkx():
    try:
        import networkx as nx
    except ImportError as e:  # pragma: no cover
        raise ImportError("graph transforms require networkx") from e
    return nx


@dataclass
class EdgeDescriptor:
    """Which node classes an edge layer connects, and how ('grid' = lattice
    adjacency restricted to those nodes; None = complete bipartite product)."""

    between: tuple[str, ...]
    structure: str | None = None


# Object name -> (coarse, fine) one-hot node attributes.
_OBJ_ATTRS = {
    "empty": ("navigable", "empty"),
    "start": ("navigable", "start"),
    "agent": ("navigable", "start"),
    "goal": ("navigable", "goal"),
    "moss": ("navigable", "moss"),
    "wall": ("non_navigable", "wall"),
    "lava": ("non_navigable", "lava"),
}

_ATTR_OBJ = {
    "empty": "empty",
    "start": "start",
    "goal": "goal",
    "moss": "moss",
    "wall": "wall",
    "lava": "lava",
    "navigable": None,
    "non_navigable": None,
}

_OBJ_COLOR = {
    "empty": None,
    "wall": "grey",
    "agent": "blue",
    "goal": "green",
    "lava": "red",
    "moss": "purple",
}

_NAVIGABLE = ("empty", "start", "goal", "moss")
_NON_NAVIGABLE = ("wall", "lava")


class GraphTransforms:
    """Namespace matching the reference's static-method API."""

    OBJECT_TO_DENSE_GRAPH_ATTRIBUTE = _OBJ_ATTRS
    DENSE_GRAPH_ATTRIBUTE_TO_OBJECT = _ATTR_OBJ
    MINIGRID_COLOR_CONFIG = _OBJ_COLOR

    # -- grid -> bitmap ---------------------------------------------------------
    @staticmethod
    def minigrid_to_bitmap(grids):
        """Encoded grids -> (interior wall bitmaps, start positions, goal
        positions), positions in (col, row) order like the reference
        (graphtransforms.py:52-69)."""
        grids = _numpy(grids)
        layout = grids[..., 0]
        bitmap = (layout == OBJECT_TO_IDX["wall"]).astype(layout.dtype)

        sx, sy, sz = np.where(layout == OBJECT_TO_IDX["agent"])
        gx, gy, gz = np.where(layout == OBJECT_TO_IDX["goal"])
        bitmaps, starts, goals = [], [], []
        for i in range(layout.shape[0]):
            bitmaps.append(bitmap[i][1:-1, 1:-1])
            starts.append(np.array([sz[i], sy[i]]))
            goals.append(np.array([gz[i], gy[i]]))
        return bitmaps, starts, goals

    # -- grid -> graph ------------------------------------------------------------
    @staticmethod
    def minigrid_to_dense_graph(minigrids, node_attr=None, edge_config=None):
        """Encoded grids [N, W, H, 3] (numpy or torch), a batched
        ``EnvState``, or a list of either -> list of node-feature graphs."""
        if hasattr(minigrids, "grid") and hasattr(minigrids, "agent_dir"):
            minigrids = [minigrids]
        first = minigrids[0]
        if hasattr(first, "grid") and hasattr(first, "agent_dir"):
            layouts = []
            for s in minigrids:
                lay = _numpy(s.grid) & 0xFF  # packed type plane, [N, W, H]
                lay = lay.reshape((-1,) + lay.shape[-2:]).copy()
                ax, ay = _numpy(s.agent_x).reshape(-1), _numpy(s.agent_y).reshape(-1)
                lay[np.arange(lay.shape[0]), ax, ay] = OBJECT_TO_IDX["agent"]
                layouts.append(lay)
            layouts = np.concatenate(layouts)
        else:
            layouts = np.concatenate([_numpy(m).reshape((-1,) + _numpy(m).shape[-3:]) for m in minigrids])[..., 0]
        graphs, _ = GraphTransforms.minigrid_layout_to_dense_graph(
            layouts, remove_border=True, node_attr=node_attr, edge_config=edge_config
        )
        return graphs

    @staticmethod
    def minigrid_layout_to_dense_graph(
        layouts: np.ndarray, remove_border=True, node_attr=None, edge_config=None
    ):
        """Batch of [N, W, H] object-index layouts -> (graphs, edge graphs).

        Node features are the one-hot attribute planes named in ``node_attr``
        (reference graphtransforms.py:95-158)."""
        layouts = _numpy(layouts)
        assert layouts.ndim == 3, f"expected [N, W, H], got ndim={layouts.ndim}"
        node_attr = [] if node_attr is None else list(node_attr)

        if remove_border:
            layouts = layouts[:, 1:-1, 1:-1]
        dim_grid = layouts.shape[1:]

        present = {IDX_TO_OBJECT[i] for i in np.unique(layouts)}
        supported = {"empty", "wall", "start", "goal", "agent", "lava", "moss"}
        assert present.issubset(supported), f"unsupported objects: {present - supported}"

        feats = {}
        for obj in present:
            # agent/start alias to the same attributes via _OBJ_ATTRS.
            mask = layouts == OBJECT_TO_IDX[obj]
            for attr in _OBJ_ATTRS[obj]:
                if attr in node_attr:
                    feats.setdefault(attr, np.zeros(layouts.shape))
                    feats[attr][mask] = 1
        for attr in node_attr:
            feats.setdefault(attr, np.zeros(layouts.shape))
            feats[attr] = feats[attr].reshape(layouts.shape[0], -1)

        return GraphTransforms.features_to_dense_graph(feats, dim_grid, edge_config)

    @staticmethod
    def features_to_dense_graph(features, dim_grid, edge_config=None):
        nx = _require_networkx()
        graphs = []
        edge_graphs: dict[str, list] = {}
        n = next(iter(features.values())).shape[0]
        for m in range(n):
            lattice = nx.grid_2d_graph(*dim_grid)
            g = nx.Graph()
            g.add_nodes_from(sorted(lattice.nodes(data=True)))
            for attr, mat in features.items():
                nx.set_node_attributes(
                    g, dict(zip(g.nodes, mat[m].tolist())), attr
                )
            if edge_config is not None:
                layers = GraphTransforms.get_edge_layers(
                    g, edge_config, list(features.keys()), dim_grid
                )
                for name, eg in layers.items():
                    g.add_edges_from(eg.edges(data=True), label=name)
                    edge_graphs.setdefault(name, []).append(eg)
            graphs.append(g)
        return graphs, edge_graphs

    # -- graph -> grid ---------------------------------------------------------------
    @staticmethod
    def graph_features_to_minigrid(graph_features, shape, padding=1):
        """Binary feature planes -> encoded (W, H, 3) uint8 grid with a wall
        border (reference graphtransforms.py:187-282)."""
        inner = (shape[0] - 2 * padding, shape[1] - 2 * padding)
        feats = {
            k: _numpy(v).reshape(inner) for k, v in graph_features.items()
        }
        attrs = list(feats.keys())

        def encoding(obj_type: str):
            if obj_type == "empty":
                return [OBJECT_TO_IDX["empty"], 0, 0]
            color = _OBJ_COLOR["agent" if obj_type == "start" else obj_type]
            return [
                OBJECT_TO_IDX["agent" if obj_type == "start" else obj_type],
                COLOR_TO_IDX[color] if color else 0,
                0,
            ]

        grid = np.full(inner + (3,), 0, dtype=np.uint8)
        grid[..., 0] = OBJECT_TO_IDX["empty"]
        wall_enc = np.array(encoding("wall"), dtype=np.uint8)

        for attr in attrs:
            obj = _ATTR_OBJ.get(attr)
            if "wall" not in attrs and attr == "navigable":
                # Coarse encoding: anything non-navigable is a wall.
                grid[feats[attr] == 0] = wall_enc
            elif obj is not None:
                grid[feats[attr] == 1] = np.array(encoding(obj), dtype=np.uint8)

        out = np.empty((shape[0], shape[1], 3), dtype=np.uint8)
        out[:] = wall_enc
        out[padding : shape[0] - padding, padding : shape[1] - padding] = grid
        return out

    @staticmethod
    def get_node_features(graph, pattern_shape, node_attributes=None, reshape=True):
        if node_attributes is None:
            node_attributes = list(next(iter(graph.nodes.data()))[1].keys())
        planes = []
        for attr in node_attributes:
            # Graphs restricted to navigable nodes imply wall elsewhere.
            default = 1.0 if attr in ("non_navigable", "wall") else 0.0
            f = np.full(pattern_shape, default)
            for node, val in graph.nodes.data(attr):
                f[node] = val
            planes.append(f.ravel() if reshape else f)
        return np.stack(planes, axis=-1), node_attributes

    @staticmethod
    def dense_graph_to_minigrid(graph, shape, padding=1):
        inner = (shape[0] - 2 * padding, shape[1] - 2 * padding)
        features, attrs = GraphTransforms.get_node_features(graph, inner)
        assert ((features == 0) | (features == 1)).all(), "features must be binary"
        return GraphTransforms.graph_features_to_minigrid(
            {k: features[..., i] for i, k in enumerate(attrs)},
            shape=shape,
            padding=padding,
        )

    # -- edge layers -----------------------------------------------------------------
    @staticmethod
    def get_edge_layers(graph, edge_config, node_attr, dim_grid):
        """Build per-relation edge graphs (reference graphtransforms.py:338-389)."""
        nx = _require_networkx()

        def partial_grid(nodes):
            lattice = nx.grid_2d_graph(*dim_grid)
            outside = [n for n in graph.nodes if n not in nodes]
            lattice.remove_nodes_from(outside)
            lattice.add_nodes_from(outside)
            g = nx.Graph()
            g.add_nodes_from(graph.nodes(data=True))
            g.add_edges_from(lattice.edges)
            return g

        def pair_edges(node_types):
            groups = [
                [n for n, a in graph.nodes.items() if a[t] >= 1.0]
                for t in node_types
            ]
            g = nx.create_empty_copy(graph, with_data=True)
            g.add_edges_from(product(*groups))
            return g

        layers = {}
        for name, desc in edge_config.items():
            if name == "navigable" and "navigable" not in node_attr:
                desc.between = _NAVIGABLE
            elif name == "non_navigable" and "non_navigable" not in node_attr:
                desc.between = _NON_NAVIGABLE
            elif not set(desc.between).issubset(node_attr):
                continue
            if desc.structure is None:
                layers[name] = pair_edges(desc.between)
            elif desc.structure == "grid":
                nodes = []
                for t in desc.between:
                    nodes += [
                        n
                        for n, a in graph.nodes.items()
                        if a[t] >= 1.0 and n not in nodes
                    ]
                layers[name] = partial_grid(nodes)
            else:
                raise NotImplementedError(f"edge structure {desc.structure}")
        return layers
