"""Share of the device's time idle a decode step: the device-busy seconds
(the union of kernel, copy and set intervals) of the decode steps profiled after
the window, over the window's host seconds a decode step."""


def read(record):
    return record.idle_share("step3")
