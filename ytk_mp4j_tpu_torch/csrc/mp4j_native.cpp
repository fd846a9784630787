// Native hot loops for the socket plane (a copy of
// ytk_mp4j_tpu/csrc/mp4j_native.cpp for the PyTorch port).
//
// The reference's per-round element-wise merge (operator.apply over the
// received segment, SURVEY.md section 3b step 2) is its CPU hot loop; here
// it is a templated C++ kernel driven through ctypes. A sorted-u64 merge
// kernel supports the sparse map path's key-union step.
//
// ABI: plain C, dispatch by (dtype code, op code). Codes must match
// ytk_mp4j_tpu_torch/operators.py (kernel_code) and
// ytk_mp4j_tpu_torch/utils/native.py.

#include <cstdint>
#include <cstddef>
#include <algorithm>

namespace {

enum DType : int32_t {
  F64 = 0,
  F32 = 1,
  I32 = 2,
  I64 = 3,
  I16 = 4,
  I8 = 5,
};

enum OpCode : int32_t {
  SUM = 0,
  PROD = 1,
  MAX = 2,
  MIN = 3,
};

template <typename T, OpCode OP>
void reduce_loop(T* __restrict acc, const T* __restrict src, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    if constexpr (OP == SUM) acc[i] += src[i];
    else if constexpr (OP == PROD) acc[i] *= src[i];
    else if constexpr (OP == MAX) acc[i] = std::max(acc[i], src[i]);
    else acc[i] = std::min(acc[i], src[i]);
  }
}

template <typename T>
int dispatch_op(int32_t op, T* acc, const T* src, int64_t n) {
  switch (op) {
    case SUM:  reduce_loop<T, SUM>(acc, src, n); return 0;
    case PROD: reduce_loop<T, PROD>(acc, src, n); return 0;
    case MAX:  reduce_loop<T, MAX>(acc, src, n); return 0;
    case MIN:  reduce_loop<T, MIN>(acc, src, n); return 0;
    default: return -1;
  }
}

}  // namespace

extern "C" {

// acc[i] = op(acc[i], src[i]) for i in [0, n). Returns 0 on success,
// -1 on unknown op, -2 on unknown dtype.
int mp4j_reduce(int32_t dtype, int32_t op, void* acc, const void* src,
                int64_t n) {
  switch (dtype) {
    case F64:
      return dispatch_op<double>(op, static_cast<double*>(acc),
                                 static_cast<const double*>(src), n);
    case F32:
      return dispatch_op<float>(op, static_cast<float*>(acc),
                                static_cast<const float*>(src), n);
    case I32:
      return dispatch_op<int32_t>(op, static_cast<int32_t*>(acc),
                                  static_cast<const int32_t*>(src), n);
    case I64:
      return dispatch_op<int64_t>(op, static_cast<int64_t*>(acc),
                                  static_cast<const int64_t*>(src), n);
    case I16:
      return dispatch_op<int16_t>(op, static_cast<int16_t*>(acc),
                                  static_cast<const int16_t*>(src), n);
    case I8:
      return dispatch_op<int8_t>(op, static_cast<int8_t*>(acc),
                                 static_cast<const int8_t*>(src), n);
    default:
      return -2;
  }
}

}  // extern "C"
