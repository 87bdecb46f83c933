// The float16 flash attention kernels (kernels 1-6 at __half, every
// variant and the tile mode): flash_attention.cu's templates and entries
// instantiated at __half instead of bf16 and fp32, built by
// ops/cuda/_build.py into a library of its own. nvcc compiles it in
// parallel with flash_attention.cu, so the float16 instantiations add no
// time to the build's longest compile. ops/cuda/flash_attention.py
// loads it for float16 tensors; the entries have the same names and
// arguments as flash_attention.cu's and refuse any other dtype.
#define PT_FLASH_FP16
#include "flash_attention.cu"
