// The pose coefficients' expressions: R[9], J[27] and H[54] of a pose from
// the cosines and sines of its roll, pitch and yaw (ca, sa, cb, sb, cc, sc)
// and the same snapped to 0 below 1e-4 (cx, sx, cy, sy, cz, sz), each
// product and sum rounded on its own. Those of
// ops/cuda/ndt_newton.py::coefficient_terms, term for term
// (tests/test_torch_newton.py compares the texts).
//
// A fragment of a function body, not a header: it writes c[kR + i], c[kJ + i]
// and c[kH + i] with whatever the including scope calls c, the twelve
// factors and __fmul_rn / __fadd_rn / __fsub_rn. ndt_reduce.cuh's
// pose_coefficients includes it with CUDA's own intrinsics (the numbers);
// ndt_newton.cu's terms::table() with those names bound to constexpr
// functions that record each term (the same text as one code a
// coefficient, for a warp). No include guard: a translation unit may
// include it in both.
  // BEGIN coefficient_terms
  c[kR + 0] = __fmul_rn(cb, cc);
  c[kR + 1] = __fmul_rn(-cb, sc);
  c[kR + 2] = sb;
  c[kR + 3] = __fadd_rn(__fmul_rn(ca, sc), __fmul_rn(__fmul_rn(sa, sb), cc));
  c[kR + 4] = __fsub_rn(__fmul_rn(ca, cc), __fmul_rn(__fmul_rn(sa, sb), sc));
  c[kR + 5] = __fmul_rn(-sa, cb);
  c[kR + 6] = __fsub_rn(__fmul_rn(sa, sc), __fmul_rn(__fmul_rn(ca, sb), cc));
  c[kR + 7] = __fadd_rn(__fmul_rn(sa, cc), __fmul_rn(__fmul_rn(ca, sb), sc));
  c[kR + 8] = __fmul_rn(ca, cb);
  c[kJ + 0] = 0.0f;
  c[kJ + 1] = 0.0f;
  c[kJ + 2] = 0.0f;
  c[kJ + 3] = __fmul_rn(-sy, cz);
  c[kJ + 4] = __fmul_rn(sy, sz);
  c[kJ + 5] = cy;
  c[kJ + 6] = __fmul_rn(-cy, sz);
  c[kJ + 7] = __fmul_rn(-cy, cz);
  c[kJ + 8] = 0.0f;
  c[kJ + 9] = __fadd_rn(__fmul_rn(-sx, sz), __fmul_rn(__fmul_rn(cx, sy), cz));
  c[kJ + 10] = __fsub_rn(__fmul_rn(-sx, cz), __fmul_rn(__fmul_rn(cx, sy), sz));
  c[kJ + 11] = __fmul_rn(-cx, cy);
  c[kJ + 12] = __fmul_rn(__fmul_rn(sx, cy), cz);
  c[kJ + 13] = __fmul_rn(__fmul_rn(-sx, cy), sz);
  c[kJ + 14] = __fmul_rn(sx, sy);
  c[kJ + 15] = __fsub_rn(__fmul_rn(cx, cz), __fmul_rn(__fmul_rn(sx, sy), sz));
  c[kJ + 16] = __fsub_rn(__fmul_rn(-cx, sz), __fmul_rn(__fmul_rn(sx, sy), cz));
  c[kJ + 17] = 0.0f;
  c[kJ + 18] = __fadd_rn(__fmul_rn(cx, sz), __fmul_rn(__fmul_rn(sx, sy), cz));
  c[kJ + 19] = __fsub_rn(__fmul_rn(cx, cz), __fmul_rn(__fmul_rn(sx, sy), sz));
  c[kJ + 20] = __fmul_rn(-sx, cy);
  c[kJ + 21] = __fmul_rn(__fmul_rn(-cx, cy), cz);
  c[kJ + 22] = __fmul_rn(__fmul_rn(cx, cy), sz);
  c[kJ + 23] = __fmul_rn(-cx, sy);
  c[kJ + 24] = __fadd_rn(__fmul_rn(sx, cz), __fmul_rn(__fmul_rn(cx, sy), sz));
  c[kJ + 25] = __fsub_rn(__fmul_rn(__fmul_rn(cx, sy), cz), __fmul_rn(sx, sz));
  c[kJ + 26] = 0.0f;
  c[kH + 0] = 0.0f;
  c[kH + 1] = 0.0f;
  c[kH + 2] = 0.0f;
  c[kH + 3] = __fsub_rn(__fmul_rn(-cx, sz), __fmul_rn(__fmul_rn(sx, sy), cz));
  c[kH + 4] = __fadd_rn(__fmul_rn(-cx, cz), __fmul_rn(__fmul_rn(sx, sy), sz));
  c[kH + 5] = __fmul_rn(sx, cy);
  c[kH + 6] = __fadd_rn(__fmul_rn(-sx, sz), __fmul_rn(__fmul_rn(cx, sy), cz));
  c[kH + 7] = __fsub_rn(__fmul_rn(__fmul_rn(-cx, sy), sz), __fmul_rn(sx, cz));
  c[kH + 8] = __fmul_rn(-cx, cy);
  c[kH + 9] = 0.0f;
  c[kH + 10] = 0.0f;
  c[kH + 11] = 0.0f;
  c[kH + 12] = __fmul_rn(__fmul_rn(cx, cy), cz);
  c[kH + 13] = __fmul_rn(__fmul_rn(-cx, cy), sz);
  c[kH + 14] = __fmul_rn(cx, sy);
  c[kH + 15] = __fmul_rn(__fmul_rn(sx, cy), cz);
  c[kH + 16] = __fmul_rn(__fmul_rn(-sx, cy), sz);
  c[kH + 17] = __fmul_rn(sx, sy);
  c[kH + 18] = 0.0f;
  c[kH + 19] = 0.0f;
  c[kH + 20] = 0.0f;
  c[kH + 21] = __fsub_rn(__fmul_rn(-sx, cz), __fmul_rn(__fmul_rn(cx, sy), sz));
  c[kH + 22] = __fsub_rn(__fmul_rn(sx, sz), __fmul_rn(__fmul_rn(cx, sy), cz));
  c[kH + 23] = 0.0f;
  c[kH + 24] = __fsub_rn(__fmul_rn(cx, cz), __fmul_rn(__fmul_rn(sx, sy), sz));
  c[kH + 25] = __fsub_rn(__fmul_rn(__fmul_rn(-sx, sy), cz), __fmul_rn(cx, sz));
  c[kH + 26] = 0.0f;
  c[kH + 27] = __fmul_rn(-cy, cz);
  c[kH + 28] = __fmul_rn(cy, sz);
  c[kH + 29] = sy;
  c[kH + 30] = __fmul_rn(__fmul_rn(-sx, sy), cz);
  c[kH + 31] = __fmul_rn(__fmul_rn(sx, sy), sz);
  c[kH + 32] = __fmul_rn(sx, cy);
  c[kH + 33] = __fmul_rn(__fmul_rn(cx, sy), cz);
  c[kH + 34] = __fmul_rn(__fmul_rn(-cx, sy), sz);
  c[kH + 35] = __fmul_rn(-cx, cy);
  c[kH + 36] = __fmul_rn(sy, sz);
  c[kH + 37] = __fmul_rn(sy, cz);
  c[kH + 38] = 0.0f;
  c[kH + 39] = __fmul_rn(__fmul_rn(-sx, cy), sz);
  c[kH + 40] = __fmul_rn(__fmul_rn(-sx, cy), cz);
  c[kH + 41] = 0.0f;
  c[kH + 42] = __fmul_rn(__fmul_rn(cx, cy), sz);
  c[kH + 43] = __fmul_rn(__fmul_rn(cx, cy), cz);
  c[kH + 44] = 0.0f;
  c[kH + 45] = __fmul_rn(-cy, cz);
  c[kH + 46] = __fmul_rn(cy, sz);
  c[kH + 47] = 0.0f;
  c[kH + 48] = __fsub_rn(__fmul_rn(-cx, sz), __fmul_rn(__fmul_rn(sx, sy), cz));
  c[kH + 49] = __fadd_rn(__fmul_rn(-cx, cz), __fmul_rn(__fmul_rn(sx, sy), sz));
  c[kH + 50] = 0.0f;
  c[kH + 51] = __fadd_rn(__fmul_rn(-sx, sz), __fmul_rn(__fmul_rn(cx, sy), cz));
  c[kH + 52] = __fsub_rn(__fmul_rn(__fmul_rn(-cx, sy), sz), __fmul_rn(sx, cz));
  c[kH + 53] = 0.0f;
  // END coefficient_terms
