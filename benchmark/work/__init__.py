"""The work of the port's kernels, counted from the shapes.

Each function gives (bytes, FLOPs) of one call as the algorithm needs it
at those shapes: every input byte read once, every output byte written
once, the FLOPs of the products the call computes; never what a kernel's
own loops happen to read again. So the count stays the same whatever
implements the kernel. ``peaks`` holds the card's published peaks and the
least time a call could take.
"""
