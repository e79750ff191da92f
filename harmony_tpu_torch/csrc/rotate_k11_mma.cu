// K11 in the bf16 product form (ROADMAP B.1): rotate.cu's part 5, a library
// of its own so that nvcc compiles it beside the other parts. The kernel
// and its notes are rotate.cu's.
#define ROTATE_PART 5
#include "rotate.cu"
