"""Work counts: the FLOP and bytes of what each kernel computes, from the
model's layer shapes and the dtypes its configuration states, never from
how the program computes them.  One file a kernel, with the names its
device kernels carry in a profiler trace."""
