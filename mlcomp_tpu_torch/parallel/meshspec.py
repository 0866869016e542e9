"""Pure mesh-spec arithmetic — importable by the server/supervisor
without pulling jax.

The reference's subtlest scheduler logic is GPU-slot assignment with
`distr`/`single_node` semantics (reference server/back/supervisor.py:
228-317). Re-based on TPU topology, the extra invariant is LINK
PLACEMENT: collectives on ``tp``/``sp``/``ep`` are latency- and
bandwidth-critical (all-gather / all-to-all every layer) and must ride
intra-host ICI, while ``dp``/``fsdp``/``pp`` tolerate DCN. The
supervisor therefore grants per-host core counts in MULTIPLES of the
intra-host axis product, and the DAG builder rejects specs that cannot
be placed at all — at build time, not hours later at executor mesh
construction.
"""

import math
from typing import Dict, Optional, Tuple

#: canonical axis order, outer -> inner; outer axes land on slower/DCN
#: links when a mesh spans hosts (mirrored by parallel/mesh.py, which
#: re-exports this)
AXIS_ORDER = ('dp', 'fsdp', 'ep', 'pp', 'sp', 'tp')

#: axes whose collectives must stay on intra-host ICI: tensor- and
#: sequence-parallel all-gathers run every layer; expert all-to-all is
#: similarly bandwidth-bound. dp/fsdp (per-step gradient reduce) and pp
#: (point-to-point activations) tolerate the DCN boundary.
ICI_AXES = ('ep', 'sp', 'tp')


def check_mesh_spec(spec: Dict) -> Tuple[int, Optional[str]]:
    """Syntax + arithmetic checks a mesh spec must pass regardless of
    device count. Returns (fixed_axes_product, wildcard_axis_or_None).
    Raises ValueError with a config-author-facing message otherwise."""
    if not isinstance(spec, dict):
        raise ValueError(f'mesh: must be a mapping, got {type(spec)}')
    unknown = set(spec) - set(AXIS_ORDER)
    if unknown:
        raise ValueError(
            f'unknown mesh axes {sorted(unknown)}; valid: {AXIS_ORDER}')
    wild = []
    for axis, size in spec.items():
        if not isinstance(size, int) or size == 0 or size < -1:
            raise ValueError(
                f'mesh axis {axis}: size must be a positive int or -1 '
                f'(remainder), got {size!r}')
        if size == -1:
            wild.append(axis)
    if len(wild) > 1:
        raise ValueError(
            f'at most one mesh axis may be -1, got {sorted(wild)}')
    fixed = math.prod(v for v in spec.values() if v != -1)
    return fixed, (wild[0] if wild else None)


def intra_host_product(spec: Dict) -> int:
    """Product of the fixed ICI-bound axis sizes — the granularity the
    supervisor must grant per-host cores in."""
    return math.prod(int(spec.get(a, 1)) for a in ICI_AXES
                     if int(spec.get(a, 1)) != -1)


def validate_mesh_request(spec: Dict, cores_min: int, cores_max: int,
                          single_node: bool):
    """Build-time validation of a task's ``mesh:`` against its
    ``cores:`` request (reference defers every such error to run time —
    here a bad DAG fails at submission). Raises ValueError."""
    fixed, wild = check_mesh_spec(spec)
    if wild is None:
        # a fully-pinned mesh needs EXACTLY its product in cores; a
        # range that can grant anything else fails late at mesh build
        if cores_max and fixed != cores_max:
            raise ValueError(
                f'mesh {spec} needs exactly {fixed} cores but '
                f'cores: requests up to {cores_max} — use '
                f'cores: {fixed}-{fixed} or add a -1 remainder axis')
        if cores_min and cores_min != fixed:
            raise ValueError(
                f'mesh {spec} needs exactly {fixed} cores but '
                f'cores: guarantees only {cores_min} — use '
                f'cores: {fixed}-{fixed}')
    else:
        if cores_max and cores_max % max(fixed, 1):
            raise ValueError(
                f'mesh {spec}: fixed axes product {fixed} must divide '
                f'the cores request ({cores_max}) so the -1 axis '
                f'({wild}) gets a whole number')
    if not single_node and wild in ICI_AXES:
        raise ValueError(
            f'mesh axis {wild}: -1 cannot combine with multi-host '
            f'placement (single_node: false) — {wild} collectives must '
            f'stay on intra-host ICI, so pin its size')


def host_grant_granularity(spec: Optional[Dict]) -> int:
    """Cores-per-host granularity for the supervisor: multiples of the
    intra-host axis product keep tp/sp/ep collectives off the DCN
    boundary. 1 when no mesh is requested."""
    if not spec:
        return 1
    return max(1, intra_host_product(spec))


def mesh_reshapeable(spec: Optional[Dict]) -> bool:
    """Can a gang with this mesh spec come back on FEWER cores after a
    host preemption? A remainder (-1) axis absorbs the lost cores (the
    wildcard recomputes against whatever grant placement finds, in
    fixed-axes-product multiples); so does no mesh at all. A fully
    pinned spec needs exactly its product — the elastic requeue then
    waits for capacity instead of dispatching a gang that would die at
    ``normalize_mesh_spec``."""
    if not spec:
        return True
    _, wild = check_mesh_spec(spec)
    return wild is not None


__all__ = ['AXIS_ORDER', 'ICI_AXES', 'check_mesh_spec',
           'intra_host_product', 'validate_mesh_request',
           'host_grant_granularity', 'mesh_reshapeable']
