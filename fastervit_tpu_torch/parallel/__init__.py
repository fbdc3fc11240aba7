"""Data parallel training: the rendezvous (`distributed.initialize`), the
model's wrapping in DistributedDataParallel with synchronised BatchNorm and
the batch's mirrored exchange for mixup (`data_parallel`), and one step of
each training path under it (`dryrun`)."""
