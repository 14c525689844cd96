/* Clock-fault helper, compiled on each db node by the clock nemesis.
 *
 * Same capability as the reference's resources/bump-time.c
 * (jepsen/nemesis/time.clj compiles it with cc on the node, SURVEY.md
 * §2.5 item 5): jump the system clock by a signed millisecond offset, or
 * strobe it back and forth between +delta and 0 for a duration.
 *
 *   bump_time bump <ms>                      jump clock by <ms>
 *   bump_time strobe <delta_ms> <period_ms> <duration_ms>
 *                                            oscillate for duration
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/time.h>
#include <time.h>
#include <unistd.h>

static int bump(long long ms) {
  struct timeval tv;
  if (gettimeofday(&tv, NULL)) { perror("gettimeofday"); return 1; }
  long long usec = (long long)tv.tv_sec * 1000000LL + tv.tv_usec
                   + ms * 1000LL;
  tv.tv_sec  = usec / 1000000LL;
  tv.tv_usec = usec % 1000000LL;
  if (settimeofday(&tv, NULL)) { perror("settimeofday"); return 1; }
  return 0;
}

static long long now_ms(void) {
  struct timeval tv;
  gettimeofday(&tv, NULL);
  return (long long)tv.tv_sec * 1000LL + tv.tv_usec / 1000LL;
}

static int strobe(long long delta_ms, long long period_ms,
                  long long duration_ms) {
  long long end = now_ms() + duration_ms;
  int up = 0;
  while (now_ms() < end) {
    if (bump(up ? -delta_ms : delta_ms)) return 1;
    up = !up;
    usleep((useconds_t)(period_ms * 1000LL));
  }
  if (up && bump(-delta_ms)) return 1; /* leave the clock where it began */
  return 0;
}

int main(int argc, char **argv) {
  if (argc >= 3 && !strcmp(argv[1], "bump"))
    return bump(atoll(argv[2]));
  if (argc >= 5 && !strcmp(argv[1], "strobe"))
    return strobe(atoll(argv[2]), atoll(argv[3]), atoll(argv[4]));
  fprintf(stderr,
          "usage: %s bump <ms> | strobe <delta_ms> <period_ms> <dur_ms>\n",
          argv[0]);
  return 2;
}
