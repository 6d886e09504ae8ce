"""tools/host_sampler.py: a script run under the stack sampler, its
report's inclusive and leaf times, and the script's exit code kept."""

import re
import textwrap

from aod_meh_hua_torch.tools import host_sampler

SCRIPT = textwrap.dedent("""
    import sys, time

    def spin(seconds):
        t0 = time.time()
        while time.time() - t0 < seconds:
            pass

    def outer():
        spin(0.6)

    outer()
    sys.exit(int(sys.argv[1]))
""")


def _seconds(report: str, key: str) -> float:
    return sum(float(m.group(1)) for m in re.finditer(rf"^\s*([0-9.]+) {key}", report, re.M))


def test_report_names_the_busy_function_and_keeps_the_exit_code(tmp_path):
    script = tmp_path / "busy.py"
    script.write_text(SCRIPT)
    out = tmp_path / "samples.txt"
    code = host_sampler.main(["--out", str(out), "--interval", "0.01", str(script), "3"])
    assert code == 3
    report = out.read_text()
    inclusive, leaf = report.split("\nLEAF\n")
    assert report.startswith("wall ")
    # the spin loop holds most of the samples, inside outer's
    assert 0.3 <= _seconds(inclusive, r"busy\.py:spin:4") <= _seconds(inclusive,
                                                                     r"busy\.py:outer:9")
    assert _seconds(leaf, r"busy\.py:spin:4@") >= 0.3


def test_report_of_a_script_that_raises(tmp_path):
    script = tmp_path / "bad.py"
    script.write_text("raise ValueError('no')\n")
    out = tmp_path / "samples.txt"
    try:
        host_sampler.main(["--out", str(out), str(script)])
    except ValueError:
        pass
    else:
        raise AssertionError("the script's exception was swallowed")
    assert out.read_text().startswith("wall ")
