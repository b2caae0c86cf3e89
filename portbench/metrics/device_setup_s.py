"""Host clock around the program's setup_device, ending in a
synchronize."""


def read(ctx):
    return ctx["device_setup_s"]
