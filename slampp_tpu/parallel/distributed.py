"""Distributed Gauss-Newton / Schur reduction over a device mesh.

The reference is a single-process OpenMP solver; its "reduction plans"
(NonlinearSolver_Lambda_Base.h:113,524) partition per-edge Hessian
contributions across threads.  The device-mesh generalization mandated by
BASELINE.json shards *edges* (and, for BA, landmarks) across devices:

  per-shard local lambda/eta assembly  ->  psum over the mesh  ->
  replicated (or Schur-reduced) factorization  ->  replicated update

which is the honest analog of data parallelism for this workload: the model
(state vector) is small and replicated, the measurements are the big axis.
Collectives are one ``psum`` of the reduced system per iteration (NCCL over
NVLink on GPUs).

Implemented with ``shard_map`` so the communication pattern is explicit and
the same code runs on a virtual CPU mesh (tests / driver dry-run) and on
real cards.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from slampp_tpu.core import assembly
from slampp_tpu.graph.system import EdgeArrays, GraphArrays
from slampp_tpu.linear.dense import solve_dense


def make_mesh(n_devices: int = None, axis: str = "edges") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _edge_shard_specs(graph: GraphArrays, axis: str):
    """PartitionSpecs: edge arrays sharded on the edge axis, everything else
    replicated."""

    def spec_for_edges(ea: EdgeArrays) -> EdgeArrays:
        return EdgeArrays(
            local_idx=P(axis),
            offsets=P(axis),
            meas=P(axis),
            sigma_inv=P(axis),
            valid=P(axis),
        )

    return GraphArrays(
        states={k: P() for k in graph.states},
        vertex_offsets={k: P() for k in graph.vertex_offsets},
        edges={k: spec_for_edges(v) for k, v in graph.edges.items()},
        state_dim=graph.state_dim,
        unary_offset=graph.unary_offset,
        unary_dim=graph.unary_dim,
        unary_information=graph.unary_information,
        diag_reg=P() if graph.diag_reg is not None else None,
    )


def pad_edges_to_multiple(graph: GraphArrays, m: int) -> GraphArrays:
    """Pad every edge type's capacity to a multiple of m (host-side)."""
    new_edges = {}
    for name, ea in graph.edges.items():
        cap = ea.capacity
        target = ((cap + m - 1) // m) * m
        if target == cap:
            new_edges[name] = ea
            continue
        pad = target - cap
        dummy = graph.state_dim

        def padrow(x, fill):
            shape = (pad,) + x.shape[1:]
            return jnp.concatenate([x, jnp.full(shape, fill, x.dtype)], axis=0)

        new_edges[name] = EdgeArrays(
            local_idx=padrow(ea.local_idx, 0),
            offsets=padrow(ea.offsets, dummy),
            meas=padrow(ea.meas, 0.0),
            sigma_inv=padrow(ea.sigma_inv, 0.0),
            valid=padrow(ea.valid, False),
        )
    return GraphArrays(
        graph.states,
        graph.vertex_offsets,
        new_edges,
        graph.state_dim,
        graph.unary_offset,
        graph.unary_dim,
        graph.unary_information,
        graph.diag_reg,
    )


def shard_graph_edges(graph: GraphArrays, mesh: Mesh, axis: str = "edges") -> GraphArrays:
    """Place edge arrays sharded over the mesh, states replicated."""
    graph = pad_edges_to_multiple(graph, mesh.shape[axis])
    specs = _edge_shard_specs(graph, axis)

    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    leaves, treedef = jax.tree_util.tree_flatten(graph)
    spec_leaves = jax.tree_util.tree_flatten(specs)[0]
    placed = [put(x, s) for x, s in zip(leaves, spec_leaves)]
    return jax.tree_util.tree_unflatten(treedef, placed)


def distributed_gn_step(graph: GraphArrays, mesh: Mesh, axis: str = "edges"):
    """One distributed GN iteration: sharded assembly, psum-reduced system,
    replicated dense solve + retraction.  Returns (new_states, dx_norm, chi2).
    """
    specs = _edge_shard_specs(graph, axis)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(specs,),
        out_specs=(
            {k: P() for k in graph.states},
            P(),
            P(),
        ),
        check_vma=False,
    )
    def step(local_graph: GraphArrays):
        # local shard assembles its partial lambda/eta; one psum reduces the
        # full system onto every device (the distributed "reduction plan")
        H, g, chi2 = assembly.assemble_dense(local_graph)
        # the unary gauge factor was added on every shard; keep exactly one
        n_shards = jax.lax.axis_size(axis)
        if local_graph.unary_dim > 0:
            idx = local_graph.unary_offset + jnp.arange(local_graph.unary_dim)
            H = H.at[idx, idx].add(
                -local_graph.unary_information * (n_shards - 1) / n_shards
            )
        if local_graph.diag_reg is not None:
            d = jnp.arange(H.shape[0])
            H = H.at[d, d].add(-local_graph.diag_reg * (n_shards - 1) / n_shards)
        H = jax.lax.psum(H, axis)
        g = jax.lax.psum(g, axis)
        chi2 = jax.lax.psum(chi2, axis)
        dx = solve_dense(H, g)
        new_states = assembly.apply_update(local_graph, dx)
        return new_states, jnp.linalg.norm(dx), chi2

    return step(graph)
