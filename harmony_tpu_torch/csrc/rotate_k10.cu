// K10 with fp32 products on layout tiles that are whole 64-cell pieces:
// rotate.cu's part 2, a library of its own so that nvcc compiles it beside
// the other parts. The kernel and its notes are rotate.cu's.
#define ROTATE_PART 2
#include "rotate.cu"
