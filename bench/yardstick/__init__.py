"""The benchmark's frozen measures: an H100's peaks, the model FLOPs of a
train step, a K1 launch's operations and bytes, and the reductions of a
profiler trace. They are copies taken when the benchmark was defined, so
a change to the program cannot move the yardstick it is judged by."""
