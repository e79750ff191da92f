// K7's fused moments and K10 on layout tiles that are not whole 64-cell
// pieces (a user-set mstep_tile such as 160): rotate.cu's kWhole = false
// instances and the two entry points that launch them (k7_assign with
// moments, k10_virtual_correction), a library of their own so that nvcc
// compiles them beside rotate.cu's other instances. The kernels and their
// notes are rotate.cu's.
#define ROTATE_TILE_FORMS 1
#include "rotate.cu"
