"""The share of the traced stretch of the prefill-heavy serving cell, in
%, in which the device was idle while the host was inside the port's
``model.moe`` regions: the stretch's idle gaps intersected with the union
of those regions, over the stretch's length.  None where the trace has
no device operation or no such region."""
MOE = "repro_torch.model.moe"


def read(run):
    traced = getattr(run, "traced", None)
    if traced is None or not traced.device:
        return None
    union = []
    for a, b in sorted((a, b) for n, a, b in traced.host if n == MOE):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    if not union:
        return None
    idle, i = 0.0, 0
    for g0, g1 in traced.gaps():
        while i < len(union) and union[i][1] <= g0:
            i += 1
        j = i
        while j < len(union) and union[j][0] < g1:
            idle += min(g1, union[j][1]) - max(g0, union[j][0])
            j += 1
    return 100.0 * idle / traced.window_s
