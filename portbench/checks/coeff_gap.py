"""The widest relative gap of a fitted coefficient from the reference's:
over the sampled fit answers, ||r|| / ||c_ref|| (Euclidean norms), c_ref
the float64 reference's fit at the answer's parameters and r the gap
c - c_ref, each coefficient's less any whole steps of the L1 term.

Where elasticNet * reg > 0 the proximal step moves every non-zero
coefficient by q = learningRate * elasticNet * reg an epoch towards zero,
by the sign of the coefficient. A coefficient whose value cancels to
within rounding of zero takes its sign from the rounding, so the two
arithmetics step it by q in opposite directions, or one leaves it at zero:
its gap is q or 2q, whatever the precision. On the sparse table the
coefficients themselves are about q (a column's gradient step is ~1e-6),
so a dozen such coefficients out of a million move the norm of the whole
gap by a percent on one seed and not at all on the next. So a
coefficient's gap within rounding of q or 2q counts as its distance from
that step; a gap of any other size counts whole."""

import torch

#: whole steps of the L1 term that a coefficient's sign can put between
#: the two arithmetics
STEPS = (1.0, 2.0)


def _residual(gap, q):
    """|gap| less the nearest whole L1 step where that is nearer than
    |gap| itself."""
    r = gap.abs()
    for m in STEPS:
        r = torch.minimum(r, (gap.abs() - m * q).abs())
    return r


def measure(answers, reference):
    gaps = []
    for a in answers:
        if a.request != "fit":
            continue
        p = reference.params(a.point)
        q = float(p["learningRate"]) * float(p["elasticNet"]) * float(p["reg"])
        ref = reference.fit(a.point).to(torch.float64)
        got = torch.as_tensor(a.value, dtype=torch.float64, device=ref.device)
        r = _residual(got - ref, q) if q > 0 else (got - ref).abs()
        gaps.append(float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(ref)))
    return max(gaps) if gaps else None
