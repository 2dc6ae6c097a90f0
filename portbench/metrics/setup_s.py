"""setup_s: from the harness's start to the end of the warm-up job (s):
importing torch and the port, starting the card, building what is
absent, making and writing the inputs, one warm-up job."""


def read(rec):
    return rec["setup_s"]
