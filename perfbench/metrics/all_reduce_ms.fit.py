"""Device milliseconds a step of what rank 0 launched inside the
program's span ``apt.train_step.all_reduce`` (``parallel/sharded.
make_train_step`` with a mesh): the packing ``cat`` of the loss and the
gradient and NCCL's all-reduce kernel, whose time includes its wait for
the slowest rank.  Read from the program's spans (``perfbench/spans.py``)
in the traced stretch."""

from perfbench import spans


def read(ctx):
    return spans.span_ms(ctx, "apt.train_step.all_reduce")
