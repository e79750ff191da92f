// K7's fused moments and K10 with fp32 products on layout tiles that are
// not whole 64-cell pieces (a user-set mstep_tile such as 160): rotate.cu's
// part 1, a library of its own so that nvcc compiles it beside the other
// parts. The kernels and their notes are rotate.cu's.
#define ROTATE_PART 1
#include "rotate.cu"
