"""Share of the device's time idle a scored image: the device-busy seconds
(the union of kernel, copy and set intervals) of the scored images profiled after
the window, over the window's host seconds a scored image."""


def read(record):
    return record.idle_share("step4b")
