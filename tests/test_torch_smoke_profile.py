"""``chip_smoke.profile_until`` on the CPU: a profile that disagrees with
the launches counted is taken again, up to ``PROFILE_TRIES`` profiles, and
is forgiven only where it kept fewer device records than the profile that
agrees (the profiler lost records); a disagreement in every profile, or
one with as many records as the profile that agrees, fails.  The device
record counts are scripted; the profiler runs on the CPU.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity

import chip_smoke

# (whether each profile agrees, the device records each kept, what the
# check does: "pass" or the words of its AssertionError)
CASES = {
    "agrees at once": ([True], [4296], "pass"),
    "lost records, then agrees": ([False, True], [4073, 4296], "pass"),
    "lost records twice, then agrees": ([False, False, True], [4073, 4100, 4296], "pass"),
    "disagrees with as many records": ([False, True], [4296, 4296], "kept no fewer"),
    "disagrees with more records": ([False, True], [4300, 4296], "kept no fewer"),
    "disagrees every time": ([False] * chip_smoke.PROFILE_TRIES,
                             [4073] * chip_smoke.PROFILE_TRIES, "each disagrees"),
}


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
def test_profile_until_retakes_only_lost_records(case, monkeypatch):
    agrees, records, want = CASES[case]
    runs, checked = [], []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "device_records", lambda prof: records[len(checked) - 1])

    def disagreement(prof):
        checked.append(prof)
        return None if agrees[len(checked) - 1] else "the counters added 34, the profiler saw 30"

    run = lambda: runs.append(float(torch.ones(4).sum()))  # noqa: E731
    if want == "pass":
        prof = chip_smoke.profile_until(case, run, [ProfilerActivity.CPU], disagreement)
        assert prof is checked[-1]
    else:
        with pytest.raises(AssertionError, match=want):
            chip_smoke.profile_until(case, run, [ProfilerActivity.CPU], disagreement)
    assert len(runs) == len(checked) == len(agrees) <= chip_smoke.PROFILE_TRIES
