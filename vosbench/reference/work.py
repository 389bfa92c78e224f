"""Work counts and the card's peaks: the operations and bytes that a
readout needs, its least time on the card, and the peaks the shares are
taken against (NVIDIA H100 SXM data sheet, dense rates)."""

from typing import Iterable

H100_BYTES_PER_S = 3.35e12         # HBM3
H100_FLOPS = {'float32': 67e12,    # outside the tensor cores (TF32 is off)
              'bfloat16': 989e12}  # dense bf16 tensor cores


def readout_flops(p: int, n: int, ck: int, cv: int, objects: int,
                  top_k: int) -> float:
    """The similarity of p query rows with n memory slots (two products of
    [p, Ck] x [Ck, n]: the selection-weighted squared distance expanded)
    and each object's top-k weighted sum of value rows."""
    return 4.0 * p * n * ck + 2.0 * objects * p * top_k * cv


def readout_bytes(p: int, n: int, ck: int, cv: int, objects: int,
                  groups: int, value_bytes: int) -> float:
    """Each input read once and the output written once: query keys and
    selection [p, Ck] f32, memory keys [n, Ck] f32, shrinkage [n] f32,
    slot validity [G, n] bool, every object's values [n, Cv], the readout
    [O, p, Cv] f32."""
    return (4.0 * 2 * p * ck + 4.0 * n * ck + 4.0 * n + groups * n
            + value_bytes * objects * n * cv + 4.0 * objects * p * cv)


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The larger of operations over the peak rate and bytes over the
    memory bandwidth."""
    return max(flops / H100_FLOPS[dtype], nbytes / H100_BYTES_PER_S)


def readouts_least_seconds(readouts: Iterable, ck: int, cv: int, top_k: int,
                           value_bytes: int) -> float:
    """Least time of a list of reference readouts (vos.ReadoutWork), the
    similarity in float32."""
    return sum(least_seconds(
        readout_flops(r.p, r.n, ck, cv, r.objects, top_k),
        readout_bytes(r.p, r.n, ck, cv, r.objects, r.groups, value_bytes),
        'float32') for r in readouts)


def readouts_flops(readouts: Iterable, ck: int, cv: int, top_k: int) -> float:
    return sum(readout_flops(r.p, r.n, ck, cv, r.objects, top_k)
               for r in readouts)
