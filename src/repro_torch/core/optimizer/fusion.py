"""Logic fusion (paper Sec. 4).

Three fusion patterns, applied bottom-up to a fixpoint:

1. Consecutive Map/Filter  -> FlatMap      (one-pass filter+project)
2. Join followed by Map/Filter -> Join-FlatMap  (never materialize the
   full join output that is immediately projected/filtered)
3. Concat chains -> ConcatAll              (unified IDB evaluation)

Fusing eliminates intermediate operator *state*: in DD every operator
maintains its output; in our executor every IR node materializes a
relation inside the iteration body — fusion removes those buffers and the
sort/compaction passes that come with them.
"""
from __future__ import annotations


from repro_torch.core import ir as I


def _subst_schema(outer_schema, inner_schema_map):
    """Rewrite outer column refs through an inner projection mapping
    (name -> inner ColumnRef)."""
    out = []
    for c in outer_schema:
        out.append(_subst_ref(c, inner_schema_map))
    return tuple(out)


def _subst_ref(c, m):
    if isinstance(c, str):
        return m[c]
    if isinstance(c, I.Expr):
        return I.Expr(c.op, _subst_ref(c.lhs, m), _subst_ref(c.rhs, m))
    return c


def _subst_comparisons(comps, m):
    return tuple(
        I.CompOp(c.op, _subst_ref(c.lhs, m), _subst_ref(c.rhs, m))
        for c in comps)


def _fuse_once(node: I.IR) -> I.IR:
    # Map(Map) / Map(FlatMap) / FlatMap(Map) / FlatMap(FlatMap) / Filter(...)
    if isinstance(node, I.Map) and isinstance(node.child, (I.Map, I.FlatMap)):
        inner = node.child
        m = {c: inner.schema[i] if False else c
             for i, c in enumerate(inner.schema) if isinstance(c, str)}
        # inner maps its own child's columns to inner.schema positions;
        # compose: outer refers to inner.schema names -> inner's refs
        name_to_ref = {}
        for i, c in enumerate(inner.schema):
            if isinstance(c, str):
                name_to_ref[c] = (
                    inner.schema[i] if isinstance(inner, I.Filter)
                    else _inner_source(inner, i))
        comps = inner.comparisons if isinstance(inner, I.FlatMap) else ()
        return I.FlatMap(
            inner.child, _subst_schema(node.schema, name_to_ref), comps)

    if isinstance(node, I.Filter) and isinstance(node.child,
                                                 (I.Map, I.FlatMap)):
        inner = node.child
        name_to_ref = {c: _inner_source(inner, i)
                       for i, c in enumerate(inner.schema)
                       if isinstance(c, str)}
        inner_comps = inner.comparisons if isinstance(inner, I.FlatMap) else ()
        return I.FlatMap(
            inner.child,
            _subst_schema(inner.schema, name_to_ref),
            inner_comps + _subst_comparisons(node.comparisons, name_to_ref))

    if isinstance(node, I.Map) and isinstance(node.child, I.Filter):
        inner = node.child
        return I.FlatMap(inner.child, node.schema, inner.comparisons)

    if isinstance(node, I.Filter) and isinstance(node.child, I.Filter):
        inner = node.child
        return I.Filter(inner.child, inner.comparisons + node.comparisons)

    # Map/Filter/FlatMap over Join -> JoinFlatMap
    if isinstance(node, (I.Map, I.Filter, I.FlatMap)) and isinstance(
            node.child, I.Join):
        j = node.child
        if isinstance(node, I.Filter):
            schema, comps = j.schema, node.comparisons
        else:
            schema = node.schema
            comps = node.comparisons if isinstance(node, I.FlatMap) else ()
        return I.JoinFlatMap(j.left, j.right, j.keys, schema, comps)

    # Map/Filter/FlatMap over JoinFlatMap: merge into it
    if isinstance(node, (I.Map, I.Filter, I.FlatMap)) and isinstance(
            node.child, I.JoinFlatMap):
        j = node.child
        name_to_ref = {c: _inner_source(j, i)
                       for i, c in enumerate(j.schema) if isinstance(c, str)}
        if isinstance(node, I.Filter):
            schema = j.schema
            comps = j.comparisons + _subst_comparisons(
                node.comparisons, name_to_ref)
        else:
            schema = _subst_schema(node.schema, name_to_ref)
            extra = node.comparisons if isinstance(node, I.FlatMap) else ()
            comps = j.comparisons + _subst_comparisons(extra, name_to_ref)
        return I.JoinFlatMap(j.left, j.right, j.keys, schema, comps)

    # Concat flattening -> ConcatAll
    if isinstance(node, I.Concat):
        inputs = []
        for c in (node.left, node.right):
            if isinstance(c, I.ConcatAll):
                inputs.extend(c.inputs)
            elif isinstance(c, I.Concat):
                inputs.extend([c.left, c.right])
            else:
                inputs.append(c)
        return I.ConcatAll(tuple(inputs))
    if isinstance(node, I.ConcatAll):
        if any(isinstance(c, (I.Concat, I.ConcatAll)) for c in node.inputs):
            inputs = []
            for c in node.inputs:
                if isinstance(c, I.ConcatAll):
                    inputs.extend(c.inputs)
                elif isinstance(c, I.Concat):
                    inputs.extend([c.left, c.right])
                else:
                    inputs.append(c)
            return I.ConcatAll(tuple(inputs))

    if isinstance(node, I.Distinct) and isinstance(node.child, I.Distinct):
        return node.child

    return node


def _inner_source(inner: I.IR, i: int):
    """What does column i of ``inner``'s schema read from inner's input?"""
    if isinstance(inner, (I.Map, I.FlatMap)):
        return inner.schema[i]  # refs are in terms of inner.child already
    if isinstance(inner, I.JoinFlatMap):
        return inner.schema[i]  # refs are in terms of the joined schema
    if isinstance(inner, I.Filter):
        return inner.schema[i]
    raise TypeError(type(inner))


def fuse(node: I.IR) -> I.IR:
    """Apply fusion bottom-up to fixpoint."""
    prev = None
    while prev is not node:
        prev = node
        node = I.rewrite_bottom_up(node, _fuse_once)
    return node
