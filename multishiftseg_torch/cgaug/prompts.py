"""Domain prompt sampling for CG-Aug covariate-shift generation.

Behavioural port of ``get_prompt`` (``CGAug/generation_utils.py:262-292``): 50% plain
dashcam template, otherwise weather x time (70% day) x place, plus the semantic-shift
sentence naming the pasted object (``generate_multishift_image.py`` prompt assembly).
A copy of ``multishiftseg_tpu/cgaug/prompts.py``: the same ``np.random.Generator``
gives the same prompt, draw for draw.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

DEFAULT_WEATHERS = (
    "sunny", "rainy", "foggy", "snowy", "cloudy", "overcast", "stormy", "misty",
)

# 96-city style place list (reference cfg.places); a representative public list of
# driving locales.
DEFAULT_PLACES = (
    "Aachen", "Amsterdam", "Athens", "Barcelona", "Beijing", "Berlin", "Bochum",
    "Boston", "Bremen", "Brussels", "Bucharest", "Budapest", "Buenos Aires",
    "Cairo", "Cape Town", "Chicago", "Cologne", "Copenhagen", "Darmstadt",
    "Delhi", "Dublin", "Dusseldorf", "Edinburgh", "Erfurt", "Florence",
    "Frankfurt", "Geneva", "Glasgow", "Hamburg", "Hanover", "Helsinki",
    "Hong Kong", "Istanbul", "Jakarta", "Jena", "Johannesburg", "Krefeld",
    "Kyoto", "Lima", "Lisbon", "London", "Los Angeles", "Lyon", "Madrid",
    "Manchester", "Marseille", "Melbourne", "Mexico City", "Miami", "Milan",
    "Monchengladbach", "Montreal", "Moscow", "Mumbai", "Munich", "Munster",
    "Nairobi", "Naples", "New York", "Nice", "Oslo", "Paris", "Philadelphia",
    "Prague", "Porto", "Rio de Janeiro", "Rome", "Rotterdam", "San Francisco",
    "Santiago", "Seattle", "Seoul", "Shanghai", "Singapore", "Stockholm",
    "Strasbourg", "Stuttgart", "Sydney", "Taipei", "Tokyo", "Toronto",
    "Tubingen", "Ulm", "Valencia", "Vancouver", "Venice", "Vienna", "Warsaw",
    "Weimar", "Wellington", "Zurich",
)

PLAIN_TEMPLATE = "An image sampled from various stereo video sequences taken by dash cam."
DOMAIN_TEMPLATE = (
    "An image sampled from various stereo video sequences taken by dash cam in "
    "{PLACE} in a {WEATHER} {TIME}."
)
ANOMALY_SENTENCE = " There is a {OOD} accidentally staying on the road."


def get_prompt(
    weathers: Sequence[str],
    places: Sequence[str],
    rng: np.random.Generator,
    ood_name: Optional[str] = None,
    day_prob: float = 0.7,
    plain_prob: float = 0.5,
) -> Tuple[str, str]:
    """Returns (prompt, domain_suffix). domain_suffix is '' for plain prompts,
    '_{weather}_{time}_{place}' otherwise (used in generated filenames)."""
    plain = rng.random() < plain_prob
    weather = weathers[int(rng.integers(len(weathers)))]
    time = "day" if rng.random() < day_prob else "night"
    place = places[int(rng.integers(len(places)))]
    if plain:
        prompt, domain = PLAIN_TEMPLATE, ""
    else:
        prompt = DOMAIN_TEMPLATE.format(WEATHER=weather, TIME=time, PLACE=place)
        domain = f"_{weather}_{time}_{place.replace(' ', '_')}"
    if ood_name:
        prompt += ANOMALY_SENTENCE.format(OOD=ood_name)
    return prompt, domain
