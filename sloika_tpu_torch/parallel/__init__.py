"""Several devices for the port (cf. ``sloika_tpu/parallel``): a process
group of one rank a device (:mod:`.mesh`), the strided read shares and the
gathers to rank 0 of the data pipelines (:mod:`.multihost`), the
launcher-less start of N ranks (:mod:`.spawn`), and the host thread map
(:mod:`.imap`)."""
