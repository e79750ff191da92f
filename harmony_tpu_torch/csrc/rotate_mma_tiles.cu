// K10 in the bf16 product form (ROADMAP B.1) on layout tiles that are not
// whole 64-cell pieces: rotate.cu's part 4, a library of its own so that
// nvcc compiles it beside the other parts. The kernel and its notes are
// rotate.cu's.
#define ROTATE_PART 4
#include "rotate.cu"
