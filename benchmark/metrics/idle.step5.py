"""Share of the device's time idle a training update: the device-busy seconds
(the union of kernel, copy and set intervals) of the training updates profiled after
the window, over the window's host seconds a training update."""


def read(record):
    return record.idle_share("step5")
