"""A graph and walk inputs at the edges of the walk kernel's contract
(``csrc/random_walk.cu``), in numpy, so that the card tests
(tests/test_torch_gpu.py) and the comparison with the JAX package's walk
(tests/test_torch_walks.py) feed the same vertices and uniforms."""

import numpy as np


def dead_end_graph(n: int = 2000):
    """(src, dst, weights, names, name2id) of a weighted directed graph
    where every fifth vertex and the last one have no out-edge: the last
    one's indptr is E, past the last edge."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, n - 1, 16 * n)
    src = src[src % 5 != 0]
    dst = rng.integers(0, n, src.shape[0])
    keep = src != dst
    names = [f"v{i}" for i in range(n)]
    return (src[keep], dst[keep], rng.uniform(0.5, 3.0, int(keep.sum())),
            names, {nm: i for i, nm in enumerate(names)})


def hub_graph(n: int = 6000, hub_degree: int = 4500):
    """(src, dst, weights, names, name2id) of a weighted directed graph with
    ``dead_end_graph``'s dead ends (every fifth vertex and the last one) and
    one hub, vertex 1, of ``hub_degree`` out-neighbours, that every other
    live vertex links to: the node2vec walk kernel's searches of prev's
    list take several rounds at the hub, read short lists (1-9 entries)
    whole, and meet cand == prev."""
    rng = np.random.default_rng(9)
    hub = 1
    src, dst = [np.full(hub_degree, hub)], [rng.choice(n, hub_degree,
                                                       replace=False)]
    for v in range(2, n - 1):
        if v % 5 == 0:
            continue
        d = int(rng.choice([1, 2, 3, 5, 8, 9, 17, 40]))
        src.append(np.full(d + 1, v))
        dst.append(np.append(rng.choice(n, d, replace=False), hub))
    src, dst = np.concatenate(src), np.concatenate(dst)
    keep = src != dst
    names = [f"v{i}" for i in range(n)]
    return (src[keep], dst[keep], rng.uniform(0.5, 3.0, int(keep.sum())),
            names, {nm: i for i, nm in enumerate(names)})


def walk_inputs(n_vertices: int, B: int, steps: int, seed: int):
    """(starts (B,) int32, u (steps, B, 2) float32): dead starts (vertex 0,
    and the last vertex, past the last edge), and some u0 at the float just
    below 1, whose product with a degree may round up to the degree."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, n_vertices, B).astype(np.int32)
    starts[::5] = n_vertices - 1
    starts[1::5] = 0
    u = rng.random((steps, B, 2), dtype=np.float32)
    u[:, 2::7, 0] = np.float32(1.0 - 2.0 ** -24)
    return starts, u


def node2vec_inputs(n_vertices: int, B: int, steps: int, trials: int,
                    seed: int):
    """(starts (B,) int32, u_first (B, 2), u (steps - 1, B, trials, 3)
    float32): ``walk_inputs``' dead starts, and index uniforms at the
    float just below 1 in the first step and in some trials."""
    rng = np.random.default_rng(seed)
    starts, u_first = walk_inputs(n_vertices, B, 1, seed)
    u = rng.random((max(steps - 1, 0), B, trials, 3), dtype=np.float32)
    u[:, 3::7, :, 0] = np.float32(1.0 - 2.0 ** -24)
    return starts, u_first[0], u
