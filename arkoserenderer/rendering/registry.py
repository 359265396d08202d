"""Named-resource registry with dependency recording.

Role-equivalent to the reference's Registry (arkose/rendering/Registry.h:
17-125): passes *construct* against it — declaring the tensors they create
and publishing/consuming them by string name, with producer->consumer edges
recorded exactly like Registry's NodeDependency tracking — and then at
runtime the "resources" are just entries in a frame-state dict threaded
through the jitted frame function.

Two storage classes:
  * transient  — recreated inside every frame trace (XLA is free to fuse /
                 alias them away); G-buffer targets, intermediates.
  * persistent — survive across frames (TAA history, path-tracer
                 accumulation, probe atlases). ``initial_state()`` allocates
                 them with their clear values; the frame function returns
                 their new values (donated buffers = in-place on the device, the
                 ``createOrReuseTexture2D`` analogue).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class ResourceDesc:
    name: str
    shape: tuple[int, ...]
    dtype: Any
    persistent: bool = False
    clear: float | int = 0
    producer: str | None = None


class Registry:
    def __init__(self):
        self._resources: dict[str, ResourceDesc] = {}
        self._edges: set[tuple[str, str]] = set()  # (producer, consumer)
        self._current_node: str | None = None
        self._published_by: dict[str, str] = {}

    # -- construct-time API -------------------------------------------------

    def set_current_node(self, name: str | None):
        self._current_node = name

    def create(
        self,
        name: str,
        shape: tuple[int, ...],
        dtype,
        *,
        persistent: bool = False,
        clear: float | int = 0,
    ) -> str:
        """Declare + publish a tensor resource. Returns the handle (its name)."""
        if name in self._resources:
            raise ValueError(f"resource '{name}' already created by "
                             f"'{self._resources[name].producer}'")
        self._resources[name] = ResourceDesc(
            name=name, shape=tuple(shape), dtype=dtype,
            persistent=persistent, clear=clear, producer=self._current_node,
        )
        self._published_by[name] = self._current_node or "<external>"
        return name

    def publish(self, name: str):
        """Publish a name produced at execute time without a static desc
        (e.g. a pytree like TriSetup). Records the producer for ordering."""
        if name in self._published_by:
            raise ValueError(f"'{name}' already published by {self._published_by[name]}")
        self._published_by[name] = self._current_node or "<external>"
        return name

    def get(self, name: str) -> str:
        """Declare a dependency on a previously published resource."""
        if name not in self._published_by:
            raise KeyError(
                f"node '{self._current_node}' reads '{name}' which no earlier "
                f"node published (published: {sorted(self._published_by)})"
            )
        self._edges.add((self._published_by[name], self._current_node or "<external>"))
        return name

    def has(self, name: str) -> bool:
        return name in self._published_by

    # -- runtime ----------------------------------------------------------------

    def initial_state(self) -> dict[str, jax.Array]:
        """Allocate persistent resources with their clear values.

        Built host-side (np.full -> device transfer) rather than as eager
        device ops: on a remote-compiled backend every eager op is a
        compilation."""
        out = {}
        for r in self._resources.values():
            if r.persistent:
                out[r.name] = jnp.asarray(np.full(r.shape, r.clear, r.dtype))
        return out

    def clear_value(self, name: str) -> jax.Array:
        r = self._resources[name]
        return jnp.asarray(np.full(r.shape, r.clear, r.dtype))

    @property
    def persistent_names(self) -> list[str]:
        return [r.name for r in self._resources.values() if r.persistent]

    def dependency_edges(self) -> set[tuple[str, str]]:
        return set(self._edges)

    def describe(self) -> str:
        lines = []
        for r in self._resources.values():
            kind = "persistent" if r.persistent else "transient "
            sz = np.prod(r.shape) * np.dtype(r.dtype).itemsize
            lines.append(
                f"{kind} {r.name:32s} {str(r.shape):24s} {np.dtype(r.dtype).name:10s}"
                f" {sz / 1e6:8.2f} MB  by {r.producer}"
            )
        return "\n".join(lines)
