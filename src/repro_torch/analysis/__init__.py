"""Static contracts of the port's kernels (the part of `repro.analysis`
that the integer-accumulator and dequant ops need: `bitwidth` proofs
and the `contracts` checks at op entry)."""
